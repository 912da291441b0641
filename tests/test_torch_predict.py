"""The port's serving path (load -> predict) against `bayesnf_tpu`.

Estimators fitted and saved by the JAX package load into the port, whose
means and quantiles must match the JAX package's `predict` (backend='xla')
on the same weights: means to rtol 2e-5 / atol 1e-4, quantiles to
1e-4 of the largest member noise scale (the two Chandrupatla searches may
stop at different points inside the 1e-5 CDF tolerance; see
`test_torch_quantiles.py`). Artifacts saved by the port load into the JAX
package. Count-model (NB, ZINB) artifacts of MAP, MLE and VI estimators
predict means to the same bounds and integer quantiles within one count on
at most max(1, 1%) of the rows (the bound of PARITY.md); their
`likelihood_model` objects match the JAX package's (log_prob, mean, stddev,
cdf) to rtol 2e-5 / atol 1e-4 (the CDF to the quantile search's 1e-5).

The committed golden artifact `test_data/bnf-map.chickenpox.8.port.npz` and
the JAX predictions on its training rows, `...port-pred.npz`, were made by
this script, run from the repository root on the CPU:

    import os
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    import pandas as pd
    from bayesnf_tpu import BayesianNeuralFieldMAP

    df = pd.read_csv('tests/test_data/chickenpox.8.train.csv', index_col=0,
                     parse_dates=['datetime'])
    m = BayesianNeuralFieldMAP(
        width=32, depth=2, seasonality_periods=[4.0, 52.1775],
        num_seasonal_harmonics=[2, 10],
        feature_cols=['datetime', 'latitude', 'longitude'],
        target_col='chickenpox', timetype='index', freq='W',
        standardize=['latitude', 'longitude'])
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=4, num_epochs=200,
          backend='xla')
    m.save('tests/test_data/bnf-map.chickenpox.8.port.npz')
    means, quants = m.predict(df, quantiles=(0.5, 0.025, 0.975),
                              backend='xla')
    np.savez('tests/test_data/bnf-map.chickenpox.8.port-pred.npz',
             means=np.asarray(means),
             quantiles=np.stack([np.asarray(q) for q in quants]))

Training rows, because the series trains on one county: its lat/lon
standard deviation is ~2e-14, so predictions at other counties explode.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch import calendar as t_calendar
from bayesnf_torch import data as t_data
from bayesnf_torch.inference import backends as t_backends
from bayesnf_torch.inference import predict as t_predict
from bayesnf_torch.models import field as t_field
import bayesnf_tpu
from bayesnf_tpu import calendar as j_calendar
from bayesnf_tpu import data as j_data
from bayesnf_tpu.inference import predict as j_predict
from bayesnf_tpu.models import field as j_field

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
GOLDEN = DATA / 'bnf-map.chickenpox.8.port.npz'
GOLDEN_PRED = DATA / 'bnf-map.chickenpox.8.port-pred.npz'
QS = (0.5, 0.025, 0.975)
MEANS_TOL = dict(rtol=2e-5, atol=1e-4)


def _table(n_hours=24, seed=0):
  """An hourly table of 4 sites, shaped like the benchmark's workload."""
  rng = np.random.default_rng(seed)
  sites = rng.normal(size=(4, 2))
  times = pd.date_range('2021-03-01', periods=n_hours, freq='h')
  df = pd.DataFrame(
      [(t, lat, lon) for t in times for lat, lon in sites],
      columns=['datetime', 'lat', 'lon'])
  hours = np.arange(len(df)) // 4
  df['y'] = (np.sin(2 * np.pi * hours / 24.0) + df['lat']
             + 0.1 * rng.normal(size=len(df)))
  return df


ESTIMATORS = {
    'MAP': dict(
        cls='BayesianNeuralFieldMAP', ensemble_size=2,
        kwargs=dict(width=16, depth=2, fourier_degrees=[2, 2, 2],
                    interactions=[(1, 2)], seasonality_periods=[24, 168],
                    num_seasonal_harmonics=[4, 4])),
    'MLE': dict(
        cls='BayesianNeuralFieldMLE', ensemble_size=8,
        kwargs=dict(width=16, depth=1, fourier_degrees=[1, 2, 2],
                    seasonality_periods=['D'], num_seasonal_harmonics=[3])),
}


def _kwargs(name):
  return dict(
      feature_cols=['datetime', 'lat', 'lon'], target_col='y',
      timetype='index', freq='h', standardize=['lat', 'lon'],
      **ESTIMATORS[name]['kwargs'])


@pytest.fixture(scope='module', params=sorted(ESTIMATORS))
def jax_fit(request, tmp_path_factory):
  """(name, fitted JAX estimator, its saved artifact path)."""
  name = request.param
  est = getattr(bayesnf_tpu, ESTIMATORS[name]['cls'])(**_kwargs(name))
  est.fit(_table(), seed=0, ensemble_size=ESTIMATORS[name]['ensemble_size'],
          num_epochs=10, backend='xla')
  path = tmp_path_factory.mktemp(name) / 'est.npz'
  est.save(str(path))
  return name, est, path


def _quantile_atol(params):
  """1e-4 of the largest member noise scale, 0.01 + exp(log_noise_scale)."""
  log_noise = np.asarray(torch.as_tensor(params[0]).cpu())
  return 1e-4 * (0.01 + np.exp(log_noise.max()))


def _assert_predictions_match(got, want_means, want_quantiles, params):
  means, quantiles = got
  np.testing.assert_allclose(means.cpu().numpy(), want_means, **MEANS_TOL)
  assert len(quantiles) == len(want_quantiles)
  for g, w in zip(quantiles, want_quantiles):
    np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w), rtol=2e-5,
                               atol=_quantile_atol(params))


def test_jax_artifact_predicts_like_jax(jax_fit):
  name, est, path = jax_fit
  table = _table(n_hours=30, seed=1)  # 6 hours past the training rows.
  want_means, want_q = est.predict(table, quantiles=QS, backend='xla')
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  assert type(port).__name__ == ESTIMATORS[name]['cls']
  got = port.predict(table, quantiles=QS)
  assert got[0].shape == np.asarray(want_means).shape
  _assert_predictions_match(got, np.asarray(want_means), want_q, port.params_)


def test_port_artifact_loads_in_jax(jax_fit, tmp_path):
  name, _, path = jax_fit
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  port.save(str(tmp_path / 'port.npz'))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(
      str(tmp_path / 'port.npz'))
  assert type(back).__name__ == ESTIMATORS[name]['cls']
  for a, b in zip(back.params_, port.params_):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
  table = _table(n_hours=30, seed=2)
  want_means, want_q = back.predict(table, quantiles=QS, backend='xla')
  _assert_predictions_match(port.predict(table, quantiles=QS),
                            np.asarray(want_means), want_q, port.params_)


def _golden_table():
  return pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                     parse_dates=['datetime'])


def test_committed_artifact_predicts_like_jax():
  port = bayesnf_torch.BayesianNeuralFieldMAP.load(str(GOLDEN), device='cpu')
  with np.load(GOLDEN_PRED) as ref:
    _assert_predictions_match(port.predict(_golden_table(), quantiles=QS),
                              ref['means'], list(ref['quantiles']),
                              port.params_)


def test_jax_still_reproduces_committed_predictions():
  est = bayesnf_tpu.BayesianNeuralFieldMAP.load(str(GOLDEN))
  means, quantiles = est.predict(_golden_table(), quantiles=QS, backend='xla')
  with np.load(GOLDEN_PRED) as ref:
    np.testing.assert_allclose(np.asarray(means), ref['means'], rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(quantiles, ref['quantiles']):
      np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('seasonality,freq', [
    ('Y', 'Y'), ('Q', 'Q'), ('Y', 'Q'), ('M', 'h'), ('Q', 'M'), ('Y', 'M'),
    ('M', 'D'), ('min', 's'), ('h', 's'), ('D', 's'), ('M', 's'), ('Q', 's'),
    ('Y', 's'), ('Y', 'D'), ('Y', 'W'),
])
def test_seasonality_to_float_matches_jax(seasonality, freq):
  assert (t_calendar.seasonality_to_float(seasonality, freq)
          == j_calendar.seasonality_to_float(seasonality, freq))


@pytest.mark.parametrize('freq,seasonalities', [
    ('W', ['M', 'Y']), ('h', ['D', 'W', 'M']), ('D', ['W', 'Q', 'Y']),
])
def test_calendar_matches_jax(freq, seasonalities):
  np.testing.assert_array_equal(
      t_calendar.seasonalities_to_array(seasonalities, freq),
      j_calendar.seasonalities_to_array(seasonalities, freq))


def test_data_handler_matches_jax():
  train = _golden_table()
  test = pd.read_csv(DATA / 'chickenpox.8.test.csv', index_col=0,
                     parse_dates=['datetime'])
  args = (['datetime', 'latitude', 'longitude'], 'chickenpox', 'index', 'W')
  t_handler = t_data.SpatiotemporalDataHandler(*args, standardize=['latitude'])
  j_handler = j_data.SpatiotemporalDataHandler(*args, standardize=['latitude'])
  np.testing.assert_array_equal(t_handler.get_train(train),
                                j_handler.get_train(train))
  np.testing.assert_array_equal(t_handler.get_test(test),
                                j_handler.get_test(test))
  np.testing.assert_array_equal(t_handler.get_target(train),
                                j_handler.get_target(train))
  np.testing.assert_array_equal(t_handler.get_input_scales(),
                                j_handler.get_input_scales())


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_forecast_params_match_jax(observation_model):
  kwargs = dict(width=16, depth=2, input_scales=[23.0, 1.0, 1.0],
                fourier_degrees=[2, 1, 1], interactions=[(0, 1)],
                seasonality_periods=[24.0], num_seasonal_harmonics=[3])
  j_cfg = j_field.FieldConfig.create(**kwargs)
  t_cfg = t_field.FieldConfig.create(**kwargs)
  rng = np.random.default_rng(5)
  arrays = [
      (np.clip(rng.normal(size=(2, 3) + s.shape), -2, 2) if s.is_matrix
       else rng.normal(scale=0.5, size=(2, 3) + s.shape)).astype(np.float32)
      for s in j_field.param_specs(j_cfg)
  ]
  x = np.concatenate([rng.uniform(0, 23, (37, 1)), rng.normal(size=(37, 2))],
                     axis=1).astype(np.float32)
  want = j_predict.forecast_params_bnf(
      x, observation_model, tuple(jnp.asarray(a) for a in arrays), j_cfg,
      ensemble_dims=2, chunk_size=16, backend='xla')
  got = t_predict.forecast_params_bnf(
      x, observation_model, t_field.params_from_numpy(t_cfg, arrays, 2, 'cpu'),
      t_cfg, ensemble_dims=2, chunk_size=16)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert tuple(g.shape) == np.asarray(w).shape
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                               atol=2e-5)


def test_chunking_does_not_change_predictions():
  port = bayesnf_torch.BayesianNeuralFieldMAP.load(str(GOLDEN), device='cpu')
  features = port.data_handler.get_test(_golden_table())
  config = port._field_config(features.shape)  # pylint: disable=protected-access
  runs = [
      t_predict.predict_bnf(features, 'NORMAL', port.params_, config, QS,
                            chunk_size=chunk)
      for chunk in (4096, 33)
  ]
  torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-6, atol=1e-5)
  for a, b in zip(runs[0][1], runs[1][1]):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-4)


def _count_table(model, n_hours=24, seed=0):
  table = _table(n_hours=n_hours, seed=seed)
  rng = np.random.default_rng(seed + 10)
  table['y'] = rng.poisson(np.exp(table['y'].to_numpy() / 2.0) + 1.0).astype(
      np.float32)
  if model == 'ZINB':
    table.loc[rng.uniform(size=len(table)) < 0.3, 'y'] = 0.0
  return table


COUNT_FITS = {
    'NB-MAP': ('NB', 'BayesianNeuralFieldMAP', dict(ensemble_size=3)),
    'ZINB-MLE': ('ZINB', 'BayesianNeuralFieldMLE', dict(ensemble_size=2)),
    'ZINB-VI': ('ZINB', 'BayesianNeuralFieldVI', dict(
        ensemble_size=2, sample_size_posterior=3, batch_size=48)),
}


@pytest.fixture(scope='module', params=sorted(COUNT_FITS))
def jax_count_fit(request, tmp_path_factory):
  """(model, fitted JAX count estimator, its saved artifact path)."""
  model, cls, fit_kwargs = COUNT_FITS[request.param]
  est = getattr(bayesnf_tpu, cls)(**dict(_kwargs('MAP'),
                                         observation_model=model))
  est.fit(_count_table(model), seed=0, num_epochs=10, backend='xla',
          **fit_kwargs)
  path = tmp_path_factory.mktemp(request.param) / 'est.npz'
  est.save(str(path))
  return model, est, path


def _assert_count_predictions_match(got, want_means, want_quantiles):
  means, quantiles = got
  np.testing.assert_allclose(means.cpu().numpy(), want_means, **MEANS_TOL)
  for g, w in zip(quantiles, want_quantiles):
    g = g.cpu().numpy()
    assert np.array_equal(g, np.round(g)) and (g >= 0).all()
    off = np.abs(g - np.asarray(w))
    assert off.max() <= 1.0, off.max()
    assert (off > 0).sum() <= max(1, len(g) // 100), (off > 0).sum()


def test_jax_count_artifact_predicts_like_jax(jax_count_fit):
  model, est, path = jax_count_fit
  table = _count_table(model, n_hours=30, seed=1)
  want_means, want_q = est.predict(table, quantiles=QS, backend='xla')
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  assert port.observation_model == model
  _assert_count_predictions_match(port.predict(table, quantiles=QS),
                                  np.asarray(want_means), want_q)
  # And back: the port's artifact loads in the JAX package bit for bit.
  out = path.with_name('port.npz')
  port.save(str(out))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(str(out))
  assert type(back) is type(est) and back.observation_model == model
  for a, b in zip(back.params_, port.params_):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _assert_likelihood_models_match(got, want, table):
  y = torch.tensor(table['y'].to_numpy(np.float32))
  tol = dict(rtol=2e-5, atol=1e-4)
  for name in ('mean', 'stddev'):
    np.testing.assert_allclose(getattr(got, name)().numpy(),
                               np.asarray(getattr(want, name)()), **tol,
                               err_msg=name)
  np.testing.assert_allclose(got.log_prob(y).numpy(),
                             np.asarray(want.log_prob(y.numpy())), **tol)
  np.testing.assert_allclose(got.distribution.cdf(y).numpy(),
                             np.asarray(want.distribution.cdf(y.numpy())),
                             rtol=0, atol=1e-5)
  np.testing.assert_allclose(got.cdf(y).numpy(),
                             np.asarray(want.cdf(y.numpy())), rtol=1e-4,
                             atol=1e-5)


def test_count_likelihood_model_matches_jax(jax_count_fit):
  model, est, path = jax_count_fit
  table = _count_table(model, n_hours=30, seed=2)
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  got = port.likelihood_model(table)
  assert type(got.distribution).__name__ == {
      'NB': 'NegativeBinomial', 'ZINB': 'ZeroInflatedNegativeBinomial'}[model]
  _assert_likelihood_models_match(
      got, est.likelihood_model(table, backend='xla'), table)


def test_unfitted_estimator_raises_value_error():
  est = bayesnf_torch.BayesianNeuralFieldMAP(**_kwargs('MAP'))
  with pytest.raises(ValueError, match='unfitted'):
    est.predict(_table())
  with pytest.raises(ValueError, match='unfitted'):
    est.save('unused.npz')


def test_fit_and_likelihood_model_are_not_ported():
  # Both are ported now: `fit` trains full batch and minibatch
  # (tests/test_torch_map.py), and `likelihood_model` gives the predictive
  # distribution, on the params' device, or raises unfitted.
  est = bayesnf_torch.BayesianNeuralFieldMLE(**_kwargs('MLE'))
  with pytest.raises(ValueError, match='unfitted'):
    est.likelihood_model(_table())
  est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, batch_size=10,
          device='cpu')
  assert est.losses_.shape == (1, 2, 1)
  dist = est.likelihood_model(_table(n_hours=5))
  assert type(dist.distribution).__name__ == 'Normal'
  assert dist.mean().shape == (1, 2, 20)
  assert dist.log_prob(torch.zeros(20)).shape == (1, 2)


def test_normal_likelihood_model_matches_jax(jax_fit):
  _, est, path = jax_fit
  table = _table(n_hours=30, seed=3)
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  _assert_likelihood_models_match(
      port.likelihood_model(table), est.likelihood_model(table,
                                                         backend='xla'),
      table)


def _rewrite_spec(tmp_path, **changes):
  """A copy of the golden artifact with its spec (and kwargs) changed."""
  with np.load(GOLDEN) as data:
    arrays = dict(data)
  spec = json.loads(str(arrays['spec']))
  spec['kwargs'].update(changes.pop('kwargs', {}))
  spec.update(changes)
  arrays['spec'] = np.asarray(json.dumps(spec))
  path = tmp_path / 'changed.npz'
  with open(path, 'wb') as f:
    np.savez(f, **arrays)
  return str(path)


@pytest.mark.parametrize('model', ['NB', 'ZINB'])
def test_count_artifacts_load_and_predict(tmp_path, model):
  # The golden artifact's weights read as a count model: integer quantiles.
  path = _rewrite_spec(tmp_path, kwargs=dict(observation_model=model))
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(path, device='cpu')
  assert port.observation_model == model
  means, quantiles = port.predict(_golden_table().iloc[:20], quantiles=QS)
  assert means.shape == (1, 4, 20) and bool(torch.isfinite(means).all())
  assert all(torch.equal(q, torch.round(q)) for q in quantiles)


def test_load_checks_format_class_and_device(tmp_path, monkeypatch):
  with pytest.raises(ValueError, match='holds a BayesianNeuralFieldMAP'):
    bayesnf_torch.BayesianNeuralFieldMLE.load(str(GOLDEN), device='cpu')
  with pytest.raises(ValueError, match='Not a bayesnf-tpu'):
    bayesnf_torch.BayesianNeuralFieldEstimator.load(
        _rewrite_spec(tmp_path, format='other'), device='cpu')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    bayesnf_torch.BayesianNeuralFieldEstimator.load(str(GOLDEN))


def test_fit_mesh_is_ignored(tmp_path):
  # A fit mesh of another device count than the CPU's one is ignored: the
  # estimator loads meshless, as the JAX package's does; one of 1 x 1 is
  # rebuilt (tests/test_torch_parallel.py covers meshes of several).
  path = _rewrite_spec(tmp_path, fit_mesh={'ens': 8, 'data': 1})
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(path, device='cpu')
  assert port.params_[0].shape == (1, 4)
  assert port.mesh_ is None
  path = _rewrite_spec(tmp_path, fit_mesh={'ens': 1, 'data': 1})
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(path, device='cpu')
  assert port.mesh_.shape == {'ens': 1, 'data': 1}
  assert port.params_[0].shape == (1, 4)


def test_backend_resolution():
  assert t_backends.resolve_backend('auto', 'cpu') == 'torch'
  assert t_backends.resolve_backend('auto', 'cuda:0') == 'kernel'
  assert t_backends.resolve_backend('torch', 'cuda') == 'torch'
  assert t_backends.resolve_backend('kernel', 'cuda') == 'kernel'
  with pytest.raises(ValueError, match='CUDA device'):
    t_backends.resolve_backend('kernel', 'cpu')
  with pytest.raises(ValueError, match='Unknown backend'):
    t_backends.resolve_backend('xla', 'cpu')
  port = bayesnf_torch.BayesianNeuralFieldMAP.load(str(GOLDEN), device='cpu')
  with pytest.raises(ValueError, match='CUDA device'):
    port.predict(_golden_table(), backend='kernel')
