"""The port's baseline tools (`bayesnf_torch/cli/`: `synthetic`,
`evaluate_baseline`, `baseline_gp`, `baseline_nf`, `baseline_headtohead`)
on the CPU, held against the JAX package's copies.

- `synthetic.make_series` frame for frame the JAX package's;
- `evaluate_baseline`: `load_series`, `featurize` and the RF / GBOOST /
  TSREG artifacts equal to the JAX package's on chickenpox-8 (the unseeded
  sklearn fits given the same global numpy seed); the cases of
  `tests/test_baselines.py` on the port's copies, with its mocks of the GP
  and NeuralForecast libraries;
- `baseline_headtohead`: `sklearn_methods` equal to the JAX package's on
  synthetic seed 0, a quick synthetic leg with the JAX artifact's method
  and metric keys, the tool's stop without scikit-learn, and (slow) the
  gates of `tests/test_baseline_headtohead.py` on 'torch'.
"""

import importlib.util
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from bayesnf_torch.cli import baseline_gp
from bayesnf_torch.cli import baseline_headtohead
from bayesnf_torch.cli import baseline_nf
from bayesnf_torch.cli import evaluate_baseline
from bayesnf_torch.cli import synthetic
from bayesnf_tpu.cli import baseline_gp as jax_baseline_gp
from bayesnf_tpu.cli import baseline_headtohead as jax_headtohead
from bayesnf_tpu.cli import baseline_nf as jax_baseline_nf
from bayesnf_tpu.cli import evaluate_baseline as jax_evaluate_baseline
from bayesnf_tpu.cli import synthetic as jax_synthetic
# The JAX package's own mocks of bayesnewton/objax and neuralforecast.
from test_baselines import _install_fake_bayesnewton
from test_baselines import _install_fake_neuralforecast
from test_baselines import _write_shared_location_series

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ROOT = os.path.join(ROOT, 'tests', 'test_data')
SYNTHETIC_METRICS = ['rmse', 'mae', 'crps', 'coverage_95',
                     'rmse_vs_true_mean', 'fit_seconds']


# --- synthetic ---------------------------------------------------------------


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_make_series_matches_the_jax_package(observation_model, seed):
  assert synthetic.LOCATIONS == jax_synthetic.LOCATIONS
  for got, want in zip(synthetic.make_series(observation_model, seed=seed),
                       jax_synthetic.make_series(observation_model,
                                                 seed=seed)):
    pd.testing.assert_frame_equal(got, want)


# --- evaluate_baseline -------------------------------------------------------


def test_load_series_matches_the_jax_package():
  got = evaluate_baseline.load_series(DATA_ROOT, 'chickenpox', '8')
  want = jax_evaluate_baseline.load_series(DATA_ROOT, 'chickenpox', '8')
  for g, w in zip(got[:4], want[:4]):
    np.testing.assert_array_equal(g, w)
  for g, w in zip(got[4:], want[4:]):
    assert g.equals(w)


@pytest.mark.parametrize('kwargs', [
    dict(dataset='chickenpox'),
    dict(seasonality_periods=[13.0, 52.0], num_seasonal_harmonics=[2, 4]),
], ids=['registry', 'explicit'])
def test_featurize_matches_the_jax_package(kwargs):
  x = evaluate_baseline.load_series(DATA_ROOT, 'chickenpox', '8')[0]
  np.testing.assert_array_equal(
      evaluate_baseline.featurize(x, **kwargs),
      jax_evaluate_baseline.featurize(x, **kwargs))


def test_tables_match_the_jax_package():
  assert evaluate_baseline.GBOOST_PARAMS == jax_evaluate_baseline.GBOOST_PARAMS
  assert list(evaluate_baseline.METHODS) == list(jax_evaluate_baseline.METHODS)
  assert evaluate_baseline.METHOD_DEPS == jax_evaluate_baseline.METHOD_DEPS
  assert evaluate_baseline.probe_methods() == (
      jax_evaluate_baseline.probe_methods())
  assert baseline_gp.DATASET_CONFIG_BASELINE == (
      jax_baseline_gp.DATASET_CONFIG_BASELINE)
  assert baseline_gp.ST_SVGP_CONFIG == jax_baseline_gp.ST_SVGP_CONFIG
  assert baseline_gp.SVGP_CONFIG == jax_baseline_gp.SVGP_CONFIG
  assert baseline_nf.NF_SEASONAL_FEATURES == (
      jax_baseline_nf.NF_SEASONAL_FEATURES)


@pytest.mark.parametrize('runner, kwargs, stem', [
    ('run_rf', {}, 'rf'),
    ('run_gboost', dict(n_estimators=10, use_features=True),
     'gboost-10-True'),
    ('run_tsreg', dict(tsreg_method='RIDGE'), 'tsreg-RIDGE'),
])
def test_sklearn_artifacts_match_the_jax_package(tmp_path, runner, kwargs,
                                                 stem):
  pytest.importorskip('sklearn')
  for name, module in (('port', evaluate_baseline),
                       ('jax', jax_evaluate_baseline)):
    np.random.seed(0)  # The artifact CLI's sklearn fits are unseeded.
    getattr(module, runner)(DATA_ROOT, 'chickenpox', '8',
                            str(tmp_path / name), **kwargs)

  def read(name, kind):
    return pd.read_csv(tmp_path / name / f'{stem}.chickenpox.8.{kind}.csv',
                       index_col=0 if kind == 'pred' else None)

  got, want = read('port', 'pred'), read('jax', 'pred')
  assert list(got.columns) == list(want.columns)
  assert got.index.equals(want.index)
  np.testing.assert_allclose(got.values, want.values, rtol=1e-9)
  got, want = read('port', 'log'), read('jax', 'log')
  assert list(got.columns) == list(want.columns)
  np.testing.assert_allclose(got.rmse, want.rmse, rtol=1e-9)


@pytest.mark.parametrize('runner, stem', [
    (evaluate_baseline.run_rf, 'rf'),
    (evaluate_baseline.run_tsreg, 'tsreg-OLS'),
])
def test_baseline_artifacts(tmp_path, runner, stem):
  pytest.importorskip('sklearn')
  runner(DATA_ROOT, 'chickenpox', '8', str(tmp_path))
  log = pd.read_csv(tmp_path / f'{stem}.chickenpox.8.log.csv')
  assert list(log.columns) == ['epoch', 'runtime', 'rmse', 'nlpd']
  assert np.isfinite(log.rmse[0])
  pred = pd.read_csv(tmp_path / f'{stem}.chickenpox.8.pred.csv', index_col=0)
  assert list(pred.columns) == ['yhat', 'yhat_std', 'yhat_lower', 'yhat_upper']
  assert len(pred) == 308
  assert pred.index.is_monotonic_increasing


def test_gboost_quantile_ordering(tmp_path):
  pytest.importorskip('sklearn')
  evaluate_baseline.run_gboost(
      DATA_ROOT, 'chickenpox', '8', str(tmp_path),
      n_estimators=10, use_features=False,
  )
  pred = pd.read_csv(
      tmp_path / 'gboost-10-False.chickenpox.8.pred.csv', index_col=0
  )
  # Quantile GBMs are not strictly non-crossing; check they mostly order.
  frac = np.mean(
      (pred.yhat_lower <= pred.yhat) & (pred.yhat <= pred.yhat_upper)
  )
  assert frac > 0.8


@pytest.mark.parametrize(
    'method, dep',
    [('SVGP', 'gpflow'), ('ST-SVGP', 'bayesnewton'),
     ('MF-ST-SVGP', 'bayesnewton'), ('NF', 'neuralforecast')],
)
def test_gp_nf_methods_report_missing_dependency(tmp_path, method, dep):
  with pytest.raises(SystemExit, match=dep):
    evaluate_baseline.METHODS[method](DATA_ROOT, 'chickenpox', '8',
                                      str(tmp_path))


def test_probe_reports_all_methods(capsys):
  results = evaluate_baseline.probe_methods()
  assert sorted(results) == sorted(evaluate_baseline.METHODS)
  for method, status in results.items():
    assert status == 'OK' or status.startswith('SKIPPED (missing: '), (
        method, status)
  assert evaluate_baseline.main(['--probe']) == 0
  out = capsys.readouterr().out
  for method in evaluate_baseline.METHODS:
    assert method in out


# --- baseline_gp / baseline_nf -----------------------------------------------


def test_create_spatiotemporal_grid_shapes_and_nans():
  # 2 locations, 3 times; one (time, loc) pair missing -> NaN on the grid.
  x = np.array([
      [0.0, 1.0, 1.0],
      [0.0, 2.0, 2.0],
      [1.0, 1.0, 1.0],
      [1.0, 2.0, 2.0],
      [2.0, 1.0, 1.0],
  ])
  y = np.array([10.0, 20.0, 11.0, 21.0, 12.0])
  t, r, yg = baseline_gp.create_spatiotemporal_grid(x, y)
  assert t.shape == (3, 1)
  assert r.shape == (3, 2, 2)
  assert yg.shape == (3, 2, 1)
  np.testing.assert_array_equal(t[:, 0], [0.0, 1.0, 2.0])
  np.testing.assert_array_equal(yg[0, :, 0], [10.0, 20.0])
  np.testing.assert_array_equal(yg[1, :, 0], [11.0, 21.0])
  assert yg[2, 0, 0] == 12.0 and np.isnan(yg[2, 1, 0])
  # Shuffled scattered rows regrid as the JAX package's do.
  rng = np.random.default_rng(0)
  t, lat, lon = np.meshgrid(np.arange(6.0), np.arange(3.0), np.arange(2.0))
  x = np.column_stack([t.ravel(), lat.ravel(), lon.ravel()])
  x = x[rng.permutation(len(x))[:25]]  # Scattered: 11 grid points unseen.
  y = rng.normal(size=len(x))
  for got, want in zip(baseline_gp.create_spatiotemporal_grid(x, y),
                       jax_baseline_gp.create_spatiotemporal_grid(x, y)):
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('iters, steps', [
    (8, [0, 1, 3, 7]), (10, [0, 1, 3, 7, 9]), (1, [0]), (1000, None)])
def test_checkpoint_steps_power_of_two(iters, steps):
  got = baseline_gp.checkpoint_steps(iters)
  assert got == jax_baseline_gp.checkpoint_steps(iters)
  if steps is not None:
    assert got == steps


def test_load_series_tidy_unix_standardized():
  table = baseline_gp.load_series_tidy(DATA_ROOT, 'chickenpox', '8')
  assert table.x_train.shape[1] == 3  # unix time, lat, lon
  np.testing.assert_allclose(table.x_train.mean(axis=0), 0.0, atol=1e-7)
  # Targets stay raw (not z-scored).
  assert table.y_train.max() > 10
  want = jax_baseline_gp.load_series_tidy(DATA_ROOT, 'chickenpox', '8')
  for key in ('x_train', 'y_train', 'x_test', 'y_test', 'index_train',
              'index_test'):
    np.testing.assert_array_equal(getattr(table, key), getattr(want, key))


def test_forecast_horizon():
  df_train = pd.DataFrame({'location': ['A', 'A', 'B']})
  df_test = pd.DataFrame({'location': ['A', 'B', 'B']})
  kwargs = dict(t_train=[0.0, 1.0, 1.0], t_test=[4.0, 2.0, 3.0])
  h = baseline_nf.forecast_horizon(df_train, df_test, **kwargs)
  assert h == 3  # A: 4-1=3, B: 3-1=2
  assert h == jax_baseline_nf.forecast_horizon(df_train, df_test, **kwargs)


def test_make_nf_frames_match_the_jax_package(tmp_path):
  _write_shared_location_series(str(tmp_path))
  got = baseline_nf.make_nf_frames(
      'chickenpox', *baseline_nf._load_index_frames(str(tmp_path),
                                                    'chickenpox', '0'))
  want = jax_baseline_nf.make_nf_frames(
      'chickenpox', *jax_baseline_nf._load_index_frames(str(tmp_path),
                                                        'chickenpox', '0'))
  for g, w in zip(got[:3], want[:3]):
    pd.testing.assert_frame_equal(g, w)
  assert got[3] == want[3]


@pytest.mark.parametrize('method, prefix', [
    ('ST-SVGP', 'bayesnewton-st-svgp'),
    ('MF-ST-SVGP', 'bayesnewton-mf-st-svgp'),
])
def test_st_svgp_schema_with_mock(tmp_path, monkeypatch, method, prefix):
  _install_fake_bayesnewton(monkeypatch)
  path = evaluate_baseline.METHODS[method](
      DATA_ROOT, 'chickenpox', '8', str(tmp_path / 'port'), iters=4
  )
  jax_path = jax_evaluate_baseline.METHODS[method](
      DATA_ROOT, 'chickenpox', '8', str(tmp_path / 'jax'), iters=4
  )
  assert path.endswith(f'{prefix}.chickenpox.8.pred.csv')
  log = pd.read_csv(tmp_path / 'port' / f'{prefix}.chickenpox.8.log.csv')
  assert list(log.columns) == ['epoch', 'runtime', 'rmse', 'nlpd']
  assert list(log.epoch) == [0, 1, 3]  # power-of-2 checkpoints for iters=4
  assert np.all(np.isfinite(log.rmse))
  pred = pd.read_csv(path, index_col=0)
  assert list(pred.columns) == ['yhat', 'yhat_std', 'yhat_lower', 'yhat_upper']
  assert len(pred) == 308  # all train+test rows recovered from the grid join
  assert np.all(np.isfinite(pred.values))
  # yhat = 0.5 (normalized) maps back through train stats.
  assert np.allclose(pred.yhat, pred.yhat.iloc[0])
  pd.testing.assert_frame_equal(pred, pd.read_csv(jax_path, index_col=0))


def test_nf_schema_with_mock(tmp_path, monkeypatch):
  _install_fake_neuralforecast(monkeypatch)
  data_dir = tmp_path / 'data'
  os.makedirs(data_dir)
  n_test = _write_shared_location_series(str(data_dir))
  path = evaluate_baseline.METHODS['NF'](
      str(data_dir), 'chickenpox', '0', str(tmp_path), nf_epochs=3
  )
  log = pd.read_csv(tmp_path / 'nf-nbeats.chickenpox.0.log.csv')
  assert list(log.columns) == ['epoch', 'runtime', 'rmse', 'nlpd']
  assert log.epoch[0] == 3
  pred = pd.read_csv(path, index_col=0)
  assert list(pred.columns) == ['yhat', 'yhat_std', 'yhat_lower', 'yhat_upper']
  assert len(pred) == n_test  # the test region
  assert np.all(pred.yhat == 7.0)
  assert np.all(pred.yhat_lower == 5.0)


# --- baseline_headtohead -----------------------------------------------------


def test_sklearn_methods_match_the_jax_package():
  pytest.importorskip('sklearn')
  (_, _, x_tr, y_tr, x_te, y_te, _,
   featurize) = baseline_headtohead.synthetic_split('NORMAL', 0)
  jax_featurize = lambda x: jax_evaluate_baseline.featurize(
      x, seasonality_periods=[13.0, 52.0], num_seasonal_harmonics=[2, 4])
  got = baseline_headtohead.sklearn_methods(x_tr, y_tr, x_te, featurize)
  want = jax_headtohead.sklearn_methods(x_tr, y_tr, x_te, jax_featurize)
  assert list(got) == list(want)
  for name in want:
    for key in ('yhat', 'lower', 'upper'):
      np.testing.assert_array_equal(got[name][key], want[name][key],
                                    err_msg=(name, key))
    np.testing.assert_allclose(float(got[name]['crps_fn'](y_te)),
                               float(want[name]['crps_fn'](y_te)),
                               rtol=1e-6, err_msg=name)


def _jax_leg_keys(leg):
  with open(os.path.join(ROOT, 'BASELINES_r05.json')) as f:
    return json.load(f)['legs'][leg]


def test_quick_synthetic_leg_has_the_jax_legs_keys():
  pytest.importorskip('sklearn')
  leg = baseline_headtohead.run_synthetic_leg(
      seeds=1, quick=True, include_vi=False, device='cpu')
  want = _jax_leg_keys('synthetic')
  assert list(leg) == [k for k in want if k not in ('protocol', 'bnf_vi')]
  for name, vals in leg.items():
    assert list(vals) == list(want[name])
    assert list(vals['mean']) == list(want[name]['mean']) == SYNTHETIC_METRICS
    assert len(vals['per_seed']) == 1
  assert all(np.isfinite(v) for v in leg['bnf_map']['mean'].values())


def test_main_stops_without_sklearn(tmp_path, monkeypatch, capsys):
  find_spec = importlib.util.find_spec
  monkeypatch.setattr(
      importlib.util, 'find_spec',
      lambda name, *a: None if name == 'sklearn' else find_spec(name, *a))
  out = tmp_path / 'h2h.json'
  assert baseline_headtohead.main(['--json-out', str(out), '--quick',
                                   '--device', 'cpu']) != 0
  err = capsys.readouterr().err
  assert len(err.strip().splitlines()) == 1 and 'scikit-learn' in err
  assert not out.exists()


@pytest.mark.slow
def test_bnf_map_beats_sklearn_baselines_on_synthetic():
  pytest.importorskip('sklearn')
  leg = baseline_headtohead.run_synthetic_leg(
      seeds=1, quick=False, include_vi=False, device='cpu', backend='torch'
  )
  m = {name: vals['mean'] for name, vals in leg.items()}
  bnf = m.pop('bnf_map')
  for name, vals in m.items():
    assert bnf['crps'] < vals['crps'], (name, bnf['crps'], vals['crps'])
  for name, vals in m.items():
    assert bnf['rmse_vs_true_mean'] < vals['rmse_vs_true_mean'], (
        name, bnf['rmse_vs_true_mean'], vals['rmse_vs_true_mean']
    )
  assert 0.9 <= bnf['coverage_95'] <= 1.0, bnf['coverage_95']
  for name, vals in m.items():
    assert np.isfinite(vals['rmse']) and vals['rmse'] < 2.5, (name, vals)


@pytest.mark.slow
def test_bnf_map_beats_sklearn_on_counts_point_metrics():
  pytest.importorskip('sklearn')
  leg = baseline_headtohead.run_synthetic_leg(
      seeds=1, quick=False, observation_model='NB', include_vi=False,
      device='cpu', backend='torch'
  )
  m = {name: vals['mean'] for name, vals in leg.items()}
  bnf = m.pop('bnf_map')
  for name, vals in m.items():
    assert bnf['rmse'] < vals['rmse'], (name, bnf['rmse'], vals['rmse'])
    assert bnf['mae'] < vals['mae'], (name, bnf['mae'], vals['mae'])
    assert bnf['rmse_vs_true_mean'] < vals['rmse_vs_true_mean'], (
        name, bnf['rmse_vs_true_mean'], vals['rmse_vs_true_mean']
    )
  assert 0.9 <= bnf['coverage_95'] <= 1.0, bnf['coverage_95']
