"""The port's VI (`bayesnf_torch.inference.vi`, `BayesianNeuralFieldVI`)
against `bayesnf_tpu`.

- ELBO: one surrogate, numpy standard-normal noise and numpy batch indices
  go to the port's per-member negative ELBO (on 'torch', and on 'kernel',
  which runs the plain K1 on CPU tensors) and to a JAX ELBO composed from
  the JAX package's `_surrogate_log_prob`, `prior_log_prob`,
  `apply_field_t` and `log_likelihood`, differentiated with `jax.grad`;
  full batch and minibatch, kl_weight 0.3. Losses agree to rtol 1e-5 and
  each gradient leaf to 1e-4 of its largest magnitude.
- Steps: three Adam steps from the same surrogate with the same injected
  noise and indices, the port's `make_step` against `optax.adam`; losses to
  rtol 1e-5, surrogate leaves to 1e-4 of their largest magnitude.
- The RNG-independent golden gate of `test_golden_mini_parity.py` for VI on
  chickenpox-8, and VI artifacts crossing between the packages both ways.
- The count models: the NB and ZINB ELBO and its gradients on count
  targets, at the same bounds; an NB VI fit here whose artifact predicts
  the same in the JAX package.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import vi as t_vi
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_torch.ops import special as t_special
import bayesnf_tpu
from bayesnf_tpu.cli import registry
from bayesnf_tpu.inference import vi as j_vi
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import likelihoods as j_likelihoods
from bayesnf_tpu.models import priors as j_priors
from bayesnf_tpu.ops import fused_mlp as j_fused
from bayesnf_tpu.ops import special as j_special

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
NORMAL_J = j_likelihoods.LikelihoodDist.NORMAL
NORMAL_T = t_likelihoods.LikelihoodDist.NORMAL
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
MEMBERS = 3
SAMPLES = 4
N_ROWS = 70
BATCH = 25
KL_WEIGHT = 0.3
LR = 0.01
CONFIG_KWARGS = dict(
    width=16, depth=2, input_scales=[50.0, 1.0, 1.0],
    fourier_degrees=[3, 2, 0], interactions=[(0, 1), (1, 2)],
    seasonality_periods=[7.0], num_seasonal_harmonics=[2])


def _data(seed=0):
  """(JAX config, port config, aug (N, D + 2F), target (N,)) as numpy."""
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  t_config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=(N_ROWS, 3)) * 5).astype(np.float32)
  y = (np.sin(x[:, 0]) + x[:, 1] + 0.3 * rng.normal(size=N_ROWS)).astype(
      np.float32)
  aug = np.array(j_field.aug_features_device(j_config, x))
  return j_config, t_config, aug, y


def _surrogate(config, seed=1):
  """Numpy (locs, raw_scales) of MEMBERS members, away from the init."""
  rng = np.random.default_rng(seed)
  locs, raw = [], []
  for spec in j_field.param_specs(config):
    shape = (MEMBERS,) + spec.shape
    locs.append((np.clip(rng.normal(size=shape), -2, 2) if spec.is_matrix
                 else 0.1 * rng.normal(size=shape)).astype(np.float32))
    raw.append((t_vi.RAW_SCALE_INIT + 0.2 * rng.normal(size=shape)).astype(
        np.float32))
  return locs, raw


def _noise(config, rng):
  return [rng.normal(size=(MEMBERS, SAMPLES) + s.shape).astype(np.float32)
          for s in j_field.param_specs(config)]


def _indices(rng, batch):
  """(E, B) first rows of a permutation per member, or None (full batch)."""
  if batch is None:
    return None
  return np.stack([rng.permutation(N_ROWS)[:batch] for _ in range(MEMBERS)])


def _count_targets(y, seed=4):
  """Counts whose log-mean follows the NORMAL targets, with extra zeros."""
  rng = np.random.default_rng(seed)
  counts = rng.poisson(np.exp(y / 2.0) + 1.0).astype(np.float32)
  counts[rng.uniform(size=counts.shape) < 0.2] = 0.0
  return counts


def _jax_elbo(config, aug, y, idx, batch, distribution=NORMAL_J,
              compute_dtype=None):
  """`(locs, raw_scales, noise) -> (E,)` per-member negative ELBO from the
  JAX package's own pieces; member m's batch is aug[idx[m]]. The field's
  products at `compute_dtype` (the XLA path's precision)."""
  d = config.num_inputs
  n_b = N_ROWS if idx is None else batch
  if idx is None:
    aug_b, y_b, axes = jnp.asarray(aug.T), jnp.asarray(y), None
  else:
    aug_b = jnp.asarray(np.stack([aug[i].T for i in idx]))
    y_b, axes = jnp.asarray(y[idx]), 0

  def member(locs, raw_scales, eps, aug_t, y_m):
    scales = j_vi.surrogate_scales(raw_scales)
    z = tuple(l + s * e for l, s, e in zip(locs, scales, eps))

    def one_draw(zz):
      pred = j_field.apply_field_t(config, zz, aug_t[:d], aug_t[d:],
                                   compute_dtype=compute_dtype)
      loglik = j_likelihoods.log_likelihood(distribution, zz, pred, y_m)
      return j_vi._surrogate_log_prob(locs, scales, zz) - (  # pylint: disable=protected-access
          j_priors.prior_log_prob(config, zz)
          + loglik * (N_ROWS / n_b) / KL_WEIGHT)

    return jnp.mean(jax.vmap(one_draw)(z))

  batched = jax.vmap(member, in_axes=(0, 0, 0, axes, axes))
  return lambda locs, raw, eps: batched(locs, raw, eps, aug_b, y_b)


def _port_batch(aug, y, idx):
  d = len(CONFIG_KWARGS['input_scales'])
  aug_t = torch.as_tensor(aug.T.copy())
  x_t, s_t, y_t = aug_t[:d], aug_t[d:], torch.as_tensor(y)
  if idx is None:
    return x_t, s_t, y_t
  return t_map.gather_batch(x_t, s_t, y_t, torch.as_tensor(idx))


def _leaf_close(got, want, tol, what):
  for i, (g, w) in enumerate(zip(got, want)):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (what, i)
    bound = tol * max(np.abs(w).max(), np.finfo(np.float32).tiny)
    assert np.abs(g - w).max() <= bound, (what, i, np.abs(g - w).max(), bound)


def test_softplus_inverse_and_surrogate_init():
  y = np.array([1e-3, 0.3, 1.0, 7.5], np.float32)
  np.testing.assert_allclose(
      t_special.softplus_inverse(torch.as_tensor(y)).numpy(),
      np.asarray(j_special.softplus_inverse(jnp.asarray(y))), rtol=1e-6)
  assert t_vi.RAW_SCALE_INIT == float(np.float32(np.log(np.expm1(0.3))))
  config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  locs, raw = t_vi.init_surrogate(config, 4, seed=5, device='cpu')
  again, _ = t_vi.init_surrogate(config, 4, seed=5, device='cpu')
  for spec, loc, r, a in zip(t_field.param_specs(config), locs, raw, again):
    assert tuple(loc.shape) == (4,) + spec.shape
    assert torch.equal(loc, a)
    assert bool((r == t_vi.RAW_SCALE_INIT).all())
    if spec.is_matrix:
      assert loc.abs().max() <= 2.0 and loc.std() > 0.5
    else:
      assert not loc.any()  # log-noise loc too: no nanstd init in VI
  scales = t_vi.surrogate_scales(raw)
  torch.testing.assert_close(scales[0], torch.full((4,), 0.3001), rtol=1e-6,
                             atol=0)


@pytest.mark.parametrize('batch', [None, BATCH], ids=['full', 'minibatch'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_elbo_and_gradients_match_jax(backend, batch):
  j_config, t_config, aug, y = _data()
  locs, raw = _surrogate(j_config)
  rng = np.random.default_rng(2)
  noise, idx = _noise(j_config, rng), _indices(rng, batch)
  j_elbo = _jax_elbo(j_config, aug, y, idx, batch)
  j_args = [tuple(jnp.asarray(a) for a in arrays)
            for arrays in (locs, raw, noise)]
  want = j_elbo(*j_args)
  want_grads = jax.grad(lambda l, r: j_elbo(l, r, j_args[2]).sum(),
                        argnums=(0, 1))(*j_args[:2])

  elbo = t_vi.make_elbo_losses(
      t_config, NORMAL_T, (N_ROWS / (batch or N_ROWS)) / KL_WEIGHT, backend)
  leaves = [torch.as_tensor(a).requires_grad_(True) for a in (*locs, *raw)]
  launches = t_fused.fused_train.launches
  got = elbo(leaves[:len(locs)], leaves[len(locs):],
             tuple(torch.as_tensor(a) for a in noise),
             *_port_batch(aug, y, idx))
  grads = torch.autograd.grad(got.sum(), leaves)
  assert t_fused.fused_train.launches == launches  # CPU: the plain K1
  assert got.shape == (MEMBERS,)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=LOSS_RTOL)
  _leaf_close([g.numpy() for g in grads],
              [*want_grads[0], *want_grads[1]], LEAF_TOL, 'grads')


@pytest.mark.parametrize('batch', [None, BATCH], ids=['full', 'minibatch'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_adam_steps_match_optax(backend, batch):
  j_config, t_config, aug, y = _data()
  locs, raw = _surrogate(j_config, seed=3)
  rng = np.random.default_rng(4)
  opt = optax.adam(LR)
  j_surr = (tuple(jnp.asarray(a) for a in locs),
            tuple(jnp.asarray(a) for a in raw))
  j_state = opt.init(j_surr)
  t_surr = (tuple(torch.as_tensor(a) for a in locs),
            tuple(torch.as_tensor(a) for a in raw))
  t_state = t_map.init_opt_state((*t_surr[0], *t_surr[1]))
  step = t_vi.make_step(t_config, NORMAL_T,
                        (N_ROWS / (batch or N_ROWS)) / KL_WEIGHT, LR, backend)
  for _ in range(3):
    noise, idx = _noise(j_config, rng), _indices(rng, batch)
    j_elbo = _jax_elbo(j_config, aug, y, idx, batch)
    j_noise = tuple(jnp.asarray(a) for a in noise)
    want, grads = jax.value_and_grad(
        lambda s: j_elbo(s[0], s[1], j_noise).sum())(j_surr)
    want = j_elbo(j_surr[0], j_surr[1], j_noise)
    updates, j_state = opt.update(grads, j_state)
    j_surr = optax.apply_updates(j_surr, updates)
    t_surr, t_state, got = step(t_surr, t_state,
                                tuple(torch.as_tensor(a) for a in noise),
                                *_port_batch(aug, y, idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOSS_RTOL)
    _leaf_close([p.numpy() for p in (*t_surr[0], *t_surr[1])],
                [*j_surr[0], *j_surr[1]], LEAF_TOL, 'surrogate')
  assert t_state.count == 3


def test_train_draws_the_same_noise_and_batches_on_both_backends():
  _, t_config, aug, y = _data()
  aug_t, y_t = torch.as_tensor(aug.T.copy()), torch.as_tensor(y)
  runs = []
  for backend in ('torch', 'kernel', 'torch'):
    surrogate = t_vi.init_surrogate(t_config, MEMBERS, seed=0, device='cpu')
    state = t_map.init_opt_state((*surrogate[0], *surrogate[1]))
    runs.append(t_vi.train(
        surrogate, state, aug_t, y_t, t_config, NORMAL_T, LR, 4, BATCH,
        SAMPLES, KL_WEIGHT, torch.Generator().manual_seed(9), backend))
  for other in runs[1:]:
    np.testing.assert_allclose(other[2].numpy(), runs[0][2].numpy(),
                               rtol=LOSS_RTOL)
  assert torch.equal(runs[0][2], runs[2][2])
  assert runs[0][2].shape == (MEMBERS, 4)
  # The history is the ELBO times kl_weight.
  surrogate = t_vi.init_surrogate(t_config, MEMBERS, seed=0, device='cpu')
  generator = torch.Generator().manual_seed(9)
  noise = t_vi.draw_noise(t_config, MEMBERS, SAMPLES, generator)
  idx = t_map.random_permutations(generator, MEMBERS, N_ROWS)[:, :BATCH]
  first = t_vi.make_elbo_losses(
      t_config, NORMAL_T, (N_ROWS / BATCH) / KL_WEIGHT, 'torch')(
          *surrogate, noise, *t_map.gather_batch(
              aug_t[:3], aug_t[3:], y_t, idx))
  np.testing.assert_allclose(runs[0][2][:, 0].numpy(),
                             (first * KL_WEIGHT).detach().numpy(), rtol=1e-6)


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


ESTIMATOR_KWARGS = dict(
    feature_cols=['datetime', 'lat', 'lon'], target_col='y',
    timetype='index', freq='h', standardize=['lat', 'lon'], width=16,
    depth=2, fourier_degrees=[2, 2, 2], interactions=[(1, 2)],
    seasonality_periods=[24, 168], num_seasonal_harmonics=[4, 4])


@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
def test_vi_estimator_fits_predicts_and_resamples(batch_size):
  table = _table()  # 96 rows: 3 steps of 30 per epoch.
  est = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS)
  assert est.fit(table, seed=0, ensemble_size=3, num_epochs=5,
                 sample_size_posterior=7, batch_size=batch_size,
                 device='cpu') is est
  steps = 5 * (1 if batch_size is None else 3)
  assert est.losses_.shape == (1, 3, steps)
  assert np.isfinite(est.losses_).all()
  specs = t_field.param_specs(est._field_config((1, 3)))  # pylint: disable=protected-access
  for spec, p, loc in zip(specs, est.params_, est.surrogate_[0]):
    assert tuple(p.shape) == (1, 7, 3) + spec.shape
    assert tuple(loc.shape) == (3,) + spec.shape
  means, quantiles = est.predict(_table(n_hours=30, seed=1),
                                 quantiles=(0.5, 0.9))
  assert means.shape == (1, 7, 3, 120)
  assert all(q.shape == (120,) for q in quantiles)
  before = [p.clone() for p in est.params_]
  est.resample_posterior(seed=4, sample_size_posterior=5)
  assert est.params_[7].shape == (1, 5, 3) + before[7].shape[3:]
  again = [p.clone() for p in est.resample_posterior(seed=4,
                                                     sample_size_posterior=5
                                                     ).params_]
  assert all(torch.equal(a, b) for a, b in zip(again, est.params_))
  est.resample_posterior(seed=5, sample_size_posterior=7)
  assert not torch.equal(est.params_[7], before[7])


def test_vi_refusals_and_errors():
  est = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS)
  with pytest.raises(ValueError, match='No fitted surrogate'):
    est.resample_posterior(seed=0)
  # A mesh is ported (tests/test_torch_parallel.py); what is not the port's
  # `Mesh` is refused.
  with pytest.raises(TypeError, match='bayesnf_torch.parallel.mesh.Mesh'):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            mesh=object())
  # Checkpoints and streaming are ported (tests/test_torch_checkpoint.py,
  # test_torch_streaming.py); a remote directory, a streamed full batch and
  # a remix without streaming are refused.
  for change, match in ((dict(checkpoint_dir='gs://bucket/ckpt'),
                         'remote URI'),
                        (dict(stream_chunk_steps=2), 'requires minibatch'),
                        (dict(stream_member_remix=True), 'host-streaming')):
    with pytest.raises(ValueError, match=match):
      est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
              **change)
  with pytest.raises(ValueError, match='CUDA device'):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            backend='kernel')


@pytest.mark.parametrize('batch', [None, BATCH], ids=['full', 'minibatch'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_elbo_and_gradients_match_jax(distribution, backend, batch):
  j_config, t_config, aug, y = _data()
  counts = _count_targets(y)
  locs, raw = _surrogate(j_config, seed=5)
  rng = np.random.default_rng(6)
  noise, idx = _noise(j_config, rng), _indices(rng, batch)
  j_elbo = _jax_elbo(j_config, aug, counts, idx, batch,
                     j_likelihoods.LikelihoodDist(distribution))
  j_args = [tuple(jnp.asarray(a) for a in arrays)
            for arrays in (locs, raw, noise)]
  want = j_elbo(*j_args)
  want_grads = jax.grad(lambda l, r: j_elbo(l, r, j_args[2]).sum(),
                        argnums=(0, 1))(*j_args[:2])
  elbo = t_vi.make_elbo_losses(
      t_config, t_likelihoods.LikelihoodDist(distribution),
      (N_ROWS / (batch or N_ROWS)) / KL_WEIGHT, backend)
  leaves = [torch.as_tensor(a).requires_grad_(True) for a in (*locs, *raw)]
  got = elbo(leaves[:len(locs)], leaves[len(locs):],
             tuple(torch.as_tensor(a) for a in noise),
             *_port_batch(aug, counts, idx))
  grads = torch.autograd.grad(got.sum(), leaves)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=LOSS_RTOL)
  _leaf_close([g.numpy() for g in grads],
              [*want_grads[0], *want_grads[1]], LEAF_TOL, 'grads')


def test_count_vi_fit_predicts_and_saves_for_jax(tmp_path):
  table = _table()
  table['y'] = _count_targets(table['y'].to_numpy())
  port = bayesnf_torch.BayesianNeuralFieldVI(
      **dict(ESTIMATOR_KWARGS, observation_model='NB')).fit(
          table, seed=0, ensemble_size=2, num_epochs=3, batch_size=48,
          sample_size_posterior=3, device='cpu')
  assert port.losses_.shape == (1, 2, 6) and np.isfinite(port.losses_).all()
  port.save(str(tmp_path / 'nb.npz'))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(
      str(tmp_path / 'nb.npz'))
  assert type(back).__name__ == 'BayesianNeuralFieldVI'
  assert back.observation_model == 'NB'
  new = _table(n_hours=30, seed=2)
  want_means, want_q = back.predict(new, quantiles=(0.5, 0.9), backend='xla')
  means, quantiles = port.predict(new, quantiles=(0.5, 0.9))
  np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                             rtol=2e-5, atol=1e-4)
  for g, w in zip(quantiles, want_q):
    off = np.abs(g.numpy() - np.asarray(w))
    assert off.max() <= 1.0 and (off > 0).sum() <= max(1, len(new) // 100)


def test_chickenpox_vi_mini_golden():
  """The RNG-independent VI assertions of test_golden_mini_parity.py:86-121
  on the training rows: 1 particle, 2 epochs full batch, lr 0.01,
  kl_weight 0.1, 5 draws per ELBO, 30 posterior draws.

  The width is w0 = 4.455 in expectation over the 30 log-noise draws of the
  one surrogate, but a single set of draws spreads around it: simulating
  30 draws of N(0, 0.3) gives 4.03 to 4.95 between the 5th and 95th
  percentiles, and about one seed in five falls outside [0.93, 1.12] w0.
  The gate therefore holds one fixed seed, as the JAX test holds its key;
  seed 0 gives 4.49 here."""
  data = registry.dataset_config('chickenpox')
  kwargs = dict(registry.model_config('chickenpox', 'vi'))
  kwargs.update(feature_cols=data['feature_cols'],
                target_col=data['target_col'], timetype=data['timetype'],
                freq=data['freq'], standardize=data['standardize'])
  train = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  est = bayesnf_torch.BayesianNeuralFieldVI(**kwargs).fit(
      train, seed=0, ensemble_size=1, num_epochs=2, learning_rate=0.01,
      kl_weight=0.1, sample_size_divergence=5, sample_size_posterior=30,
      device='cpu')
  means, (p50, lower, upper) = est.predict(
      train, quantiles=(0.5, 0.025, 0.975))
  golden = pd.read_csv(DATA / 'bnf-vi.chickenpox.8.mini.pred.csv',
                       index_col=0).loc[train.index]
  width = (upper - lower).numpy().mean()
  golden_width = (golden.yhat_upper - golden.yhat_lower).values.mean()
  w0 = 4.455
  assert 0.93 * w0 < width < 1.12 * w0, (width, w0)
  assert abs(width - golden_width) / golden_width < 0.3
  yhat = means.mean(dim=(0, 1, 2)).numpy()
  assert np.abs(yhat).max() < 2.0
  assert np.abs(p50.numpy() - yhat).max() < 1.0


@pytest.fixture(scope='module', name='jax_vi')
def _jax_vi(tmp_path_factory):
  """A tiny VI estimator fitted by the JAX package, and its artifact."""
  est = bayesnf_tpu.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS)
  est.fit(_table(), seed=0, ensemble_size=2, num_epochs=3, batch_size=48,
          sample_size_posterior=4, backend='xla')
  path = tmp_path_factory.mktemp('vi') / 'est.npz'
  est.save(str(path))
  return est, path


def _assert_same_predictions(port, jax_est, table):
  want_means, want_q = jax_est.predict(table, quantiles=(0.5, 0.9),
                                       backend='xla')
  means, quantiles = port.predict(table, quantiles=(0.5, 0.9))
  np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                             rtol=2e-5, atol=1e-4)
  noise = 0.01 + np.exp(port.params_[0].numpy().max())
  for g, w in zip(quantiles, want_q):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                               atol=1e-4 * noise)


def test_jax_vi_artifact_loads_and_predicts_like_jax(jax_vi):
  jax_est, path = jax_vi
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(str(path), 'cpu')
  assert type(port).__name__ == 'BayesianNeuralFieldVI'
  assert port.params_[0].shape == (1, 4, 2)
  for got, want in zip((*port.surrogate_[0], *port.surrogate_[1]),
                       (*jax_est.surrogate_[0], *jax_est.surrogate_[1])):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  _assert_same_predictions(port, jax_est, _table(n_hours=30, seed=1))
  port.resample_posterior(seed=1, sample_size_posterior=6)
  assert port.params_[0].shape == (1, 6, 2)


def test_port_vi_artifact_loads_in_jax(tmp_path):
  port = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS).fit(
      _table(), seed=0, ensemble_size=2, num_epochs=2, batch_size=48,
      sample_size_posterior=3, device='cpu')
  port.save(str(tmp_path / 'port.npz'))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(
      str(tmp_path / 'port.npz'))
  assert type(back).__name__ == 'BayesianNeuralFieldVI'
  for a, b in zip(back.params_, port.params_):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
  for a, b in zip((*back.surrogate_[0], *back.surrogate_[1]),
                  (*port.surrogate_[0], *port.surrogate_[1])):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
  np.testing.assert_array_equal(back.losses_, port.losses_)
  _assert_same_predictions(port, back, _table(n_hours=30, seed=2))
  # And back into the port, bit for bit.
  again = bayesnf_torch.BayesianNeuralFieldEstimator.load(
      str(tmp_path / 'port.npz'), 'cpu')
  for a, b in zip((*again.surrogate_[0], *again.surrogate_[1], *again.params_),
                  (*port.surrogate_[0], *port.surrogate_[1], *port.params_)):
    assert torch.equal(a, b)
  # The JAX package resamples from the port's surrogate too.
  back.resample_posterior(seed=3, sample_size_posterior=2)
  assert np.asarray(back.params_[0]).shape == (1, 2, 2)


# 'bf16' against the JAX package's 'bf16': both round the same fp32 values,
# but values an ulp apart can round to neighbouring bf16 values, so losses
# rtol 1e-3 and each gradient leaf within 2e-3 of its largest magnitude (the
# JAX package's count bounds).
BF16_LOSS_RTOL = 1e-3
BF16_LEAF_TOL = 2e-3


def _jax_kernel_elbo(config, aug, y, idx, batch, distribution, precision):
  """The JAX package's kernel-path ELBO (`vi._make_elbo_losses` with
  kernel='pallas') on injected noise: the S draws of each member folded into
  the member axis of one `fused_train` call at `precision` (Pallas
  interpret), its gradients returned through a custom VJP, and log q and
  the prior by autodiff around it."""
  d = config.num_inputs
  n_b = N_ROWS if idx is None else batch
  if idx is None:
    aug_b, y_b = jnp.asarray(aug.T), jnp.asarray(y)
  else:
    aug_b = jnp.asarray(np.stack([aug[i].T for i in idx]))
    y_b = jnp.asarray(y[idx])
  num_w = config.depth + 1

  def run_kernel(z_f):
    dense = j_field.IDX_FIRST_DENSE
    return j_fused.fused_train(
        distribution.value, config.depth, 32,
        (N_ROWS / n_b) / KL_WEIGHT, config.input_scales,
        config.fourier_degrees, config.interactions, aug_b[..., :d, :],
        aug_b[..., d:, :],
        tuple(z_f[dense + 2 * l] for l in range(num_w)),
        tuple(z_f[dense + 2 * l + 1] for l in range(num_w)),
        z_f[j_field.IDX_LOG_SCALE_ADJ], z_f[j_field.IDX_FEATURE_SCALES],
        z_f[j_field.IDX_LAYER_SCALES], z_f[j_field.IDX_ACTIVATION_LOGIT],
        jnp.stack([z_f[j_field.IDX_LOG_NOISE_SCALE],
                   z_f[j_field.IDX_NB_SHAPE_RAW],
                   z_f[j_field.IDX_ZINB_LOGIT]], axis=-1),
        y_b, precision=precision)

  @jax.custom_vjp
  def nll(z_f):
    return run_kernel(z_f)[0]

  def fwd(z_f):
    losses, *grads = run_kernel(z_f)
    return losses, tuple(grads)

  def bwd(res, g):
    grads = j_field.scatter_fused_train_grads(config, *res)
    return (tuple(gr * g.reshape((-1,) + (1,) * (gr.ndim - 1))
                  for gr in grads),)

  nll.defvjp(fwd, bwd)

  def elbo(locs, raw_scales, eps):
    scales = j_vi.surrogate_scales(raw_scales)
    z = tuple(l[:, None] + s[:, None] * e
              for l, s, e in zip(locs, scales, eps))  # (E, S, ...)
    z_f = tuple(p.reshape((MEMBERS * SAMPLES,) + p.shape[2:]) for p in z)
    prior = jax.vmap(lambda p: j_priors.prior_log_prob(config, p))(z_f)
    logq = jax.vmap(jax.vmap(j_vi._surrogate_log_prob,  # pylint: disable=protected-access
                             in_axes=(None, None, 0)))(locs, scales, z)
    target = (prior - nll(z_f)).reshape(MEMBERS, SAMPLES)
    return (logq - target).mean(axis=1)

  return elbo


@pytest.mark.parametrize('batch', [None, BATCH], ids=['full', 'minibatch'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_bf16_elbo_and_gradients_match_jax(distribution, backend, batch):
  """The 'bf16' ELBO and its gradients: 'torch' against the XLA path's
  composition (`apply_field_t(compute_dtype=bfloat16)`), the CPU kernel
  path (the plain K1) against the Pallas kernel's."""
  j_config, t_config, aug, y = _data()
  target = y if distribution == 'NORMAL' else _count_targets(y)
  j_dist = j_likelihoods.LikelihoodDist(distribution)
  locs, raw = _surrogate(j_config, seed=7)
  rng = np.random.default_rng(8)
  noise, idx = _noise(j_config, rng), _indices(rng, batch)
  if backend == 'torch':
    j_elbo = _jax_elbo(j_config, aug, target, idx, batch, j_dist,
                       compute_dtype=jnp.bfloat16)
  else:
    j_elbo = _jax_kernel_elbo(j_config, aug, target, idx, batch, j_dist,
                              'bf16')
  j_args = [tuple(jnp.asarray(a) for a in arrays)
            for arrays in (locs, raw, noise)]
  want, want_grads = jax.value_and_grad(
      lambda l, r: j_elbo(l, r, j_args[2]).sum(), argnums=(0, 1))(
          *j_args[:2])
  want = j_elbo(*j_args)
  elbo = t_vi.make_elbo_losses(
      t_config, t_likelihoods.LikelihoodDist(distribution),
      (N_ROWS / (batch or N_ROWS)) / KL_WEIGHT, backend, precision='bf16')
  leaves = [torch.as_tensor(a).requires_grad_(True) for a in (*locs, *raw)]
  got = elbo(leaves[:len(locs)], leaves[len(locs):],
             tuple(torch.as_tensor(a) for a in noise),
             *_port_batch(aug, target, idx))
  grads = torch.autograd.grad(got.sum(), leaves)
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=BF16_LOSS_RTOL)
  _leaf_close([g.numpy() for g in grads],
              [*want_grads[0], *want_grads[1]], BF16_LEAF_TOL, 'grads')


def test_kernel_elbo_composition_matches_at_f32():
  # The Pallas composition above is the JAX package's XLA one at 'f32'.
  j_config, _, aug, y = _data()
  locs, raw = _surrogate(j_config, seed=7)
  rng = np.random.default_rng(8)
  noise, idx = _noise(j_config, rng), _indices(rng, BATCH)
  j_args = [tuple(jnp.asarray(a) for a in arrays)
            for arrays in (locs, raw, noise)]
  got = _jax_kernel_elbo(j_config, aug, y, idx, BATCH, NORMAL_J, 'f32')(
      *j_args)
  want = _jax_elbo(j_config, aug, y, idx, BATCH)(*j_args)
  np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                             rtol=LOSS_RTOL)


@pytest.mark.parametrize('precision', ['bf16', 'highest'])
@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
def test_vi_precision_plumbs_through_fit(batch_size, precision):
  table = _table()
  fits = [bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=2, num_epochs=3, batch_size=batch_size,
      sample_size_posterior=2, device='cpu', precision=p)
          for p in (precision, 'f32')]
  assert np.isfinite(fits[0].losses_).all()
  if precision == 'highest':
    np.testing.assert_array_equal(fits[0].losses_, fits[1].losses_)
    assert all(torch.equal(a, b) for a, b in zip(fits[0].params_,
                                                 fits[1].params_))
  else:
    assert not np.array_equal(fits[0].losses_, fits[1].losses_)
    np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=2e-2)


def test_vi_unknown_precision_raises():
  est = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS)
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            precision='fp16')
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    t_vi.make_step(None, NORMAL_T, 1.0, LR, 'torch', precision='fp16')
