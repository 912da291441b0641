"""The port's MAP / MLE trainer (`bayesnf_torch.inference.map`) and `fit`
against `bayesnf_tpu`.

- Adam: the hand-written update against `optax.adam`, to 1 ulp.
- One step: losses and gradients of both backends' step functions against
  `jax.value_and_grad` of the JAX loss, at K1's bounds (losses rtol 2e-4,
  gradients rtol 2e-4 / atol 2e-5).
- Trajectory: from the JAX package's own initial parameters
  (`map._make_init_fn` on a one-device mesh, so no member padding), the
  port's `train` and JAX `ensemble_map(backend='xla')` run 20 full-batch
  epochs. Per-epoch losses must agree to rtol 1e-5 and final parameters to
  1e-4 of each leaf's largest magnitude. (A scratch run of a plain torch
  trainer on this CPU stayed within 3.2e-7 and 1.5e-5 of those; a looser
  bound would hide faults.) Minibatch epochs are held to the same bounds,
  the port given the per-member permutations the JAX package draws from
  its own member keys, on both step functions ('kernel' runs the plain K1
  here, with per-member (E, ., B) inputs). The NB and ZINB trajectories,
  on count targets, are held to the same bounds.
- The estimator: `fit` on the CPU, predict, and an artifact that
  `bayesnf_tpu` loads and predicts like the port; the RNG-independent
  golden assertions of `test_golden_mini_parity.py` on chickenpox-8; and
  what `fit` refuses.
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
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.models import priors as t_priors
from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_torch.ops import special as t_special
import bayesnf_tpu
from bayesnf_tpu.cli import registry
from bayesnf_tpu.inference import map as j_map
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import likelihoods as j_likelihoods
from bayesnf_tpu.models import priors as j_priors
from bayesnf_tpu.ops import special as j_special
from bayesnf_tpu.parallel import mesh as mesh_lib

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
NORMAL_J = j_likelihoods.LikelihoodDist.NORMAL
NORMAL_T = t_likelihoods.LikelihoodDist.NORMAL
STEP_LOSS_RTOL = 2e-4
STEP_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_TOL = 1e-4
MEMBERS = 3
LR = 0.005
CONFIG_KWARGS = dict(
    width=16, depth=2, input_scales=[50.0, 1.0, 1.0],
    fourier_degrees=[3, 2, 0], interactions=[(0, 1), (1, 2)],
    seasonality_periods=[7.0], num_seasonal_harmonics=[2])


def _data(n=70, seed=0):
  """(JAX config, port config, aug (N, D + 2F), target (N,)) as numpy."""
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  t_config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
  y = (np.sin(x[:, 0]) + x[:, 1] + 0.3 * rng.normal(size=n)).astype(
      np.float32)
  aug = np.array(j_field.aug_features_device(j_config, x))
  return j_config, t_config, aug, y


def _count_targets(y, distribution, seed=4):
  """Counts whose log-mean follows the NORMAL targets `y`; ZINB gets extra
  zeros."""
  rng = np.random.default_rng(seed)
  counts = rng.poisson(np.exp(y / 2.0) + 1.0).astype(np.float32)
  if distribution == 'ZINB':
    counts[rng.uniform(size=counts.shape) < 0.3] = 0.0
  return counts


def _jax_init(config, y, seed=0, with_keys=False):
  """The JAX package's initial ensemble (and member keys), on one device."""
  mesh = mesh_lib.default_mesh(jax.devices()[:1])
  log_noise = np.log(np.nanstd(y) / 2.0)
  params, _, keys, _ = j_map._make_init_fn(  # pylint: disable=protected-access
      config, LR, MEMBERS, mesh)(jax.random.PRNGKey(seed),
                                  np.float32(log_noise))
  if with_keys:
    return mesh, [np.array(p) for p in params], keys
  return mesh, [np.array(p) for p in params]


def _jax_permutations(keys, n, epochs):
  """The per-member, per-epoch row permutations of the JAX package's
  minibatch trainer: each epoch splits every member's key and permutes
  with the second half (`map._make_train_fn`)."""
  perms = []
  for _ in range(epochs):
    split = jax.vmap(jax.random.split)(keys)
    keys = split[:, 0]
    perms.append(np.array(jax.vmap(
        lambda k: jax.random.permutation(k, n))(split[:, 1])))
  return perms


def _leaf_close(got, want, tol, what):
  for i, (g, w) in enumerate(zip(got, want)):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (what, i)
    bound = tol * max(np.abs(w).max(), np.finfo(np.float32).tiny)
    assert np.abs(g - w).max() <= bound, (what, i, np.abs(g - w).max(), bound)


def test_adam_matches_optax():
  rng = np.random.default_rng(1)
  shapes = [(3,), (3, 4, 5), (3, 1)]
  params = [rng.normal(size=s).astype(np.float32) for s in shapes]
  opt = optax.adam(LR)
  j_state = opt.init([jnp.asarray(p) for p in params])
  j_params = [jnp.asarray(p) for p in params]
  t_params = [torch.as_tensor(p) for p in params]
  t_state = t_map.init_opt_state(t_params)
  for _ in range(6):
    grads = [rng.normal(scale=10.0 ** rng.integers(-6, 2), size=s).astype(
        np.float32) for s in shapes]
    j_updates, j_state = opt.update([jnp.asarray(g) for g in grads], j_state)
    j_params = optax.apply_updates(j_params, j_updates)
    t_updates, t_state = t_map.adam_update(
        [torch.as_tensor(g) for g in grads], t_state, LR)
    t_params = [p + u for p, u in zip(t_params, t_updates)]
    for a, b in zip(t_updates, j_updates):
      np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
    for a, b in zip(t_params, j_params):
      np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
  assert t_state.count == int(j_state[0].count)


def test_log_probs_and_prior_match_jax():
  rng = np.random.default_rng(2)
  x = rng.normal(scale=3.0, size=(4, 9)).astype(np.float32)
  for loc in (0.0, -1.5):
    np.testing.assert_allclose(
        t_special.logistic_log_prob(torch.as_tensor(x), loc=loc).numpy(),
        np.asarray(j_special.logistic_log_prob(jnp.asarray(x), loc=loc)),
        rtol=1e-6, atol=1e-6)
  scale = np.float32(0.7)
  np.testing.assert_allclose(
      t_special.normal_log_prob(torch.as_tensor(x[0]), torch.as_tensor(x[1]),
                                torch.as_tensor(scale)).numpy(),
      np.asarray(j_special.normal_log_prob(x[0], x[1], scale)),
      rtol=1e-6, atol=1e-6)
  j_config, t_config, _, _ = _data()
  params = [rng.normal(size=(MEMBERS,) + s.shape).astype(np.float32)
            for s in j_field.param_specs(j_config)]
  want = jax.vmap(lambda p: j_priors.prior_log_prob(j_config, p))(
      tuple(jnp.asarray(p) for p in params))
  got = t_priors.prior_log_prob(
      t_config, tuple(torch.as_tensor(p) for p in params))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_log_likelihood_matches_jax_and_count_models_raise():
  # The count models no longer raise: NB and ZINB match the JAX package too
  # (`test_count_log_likelihood_matches_jax`).
  j_config, _, _, y = _data()
  rng = np.random.default_rng(3)
  params = [rng.normal(size=(MEMBERS,) + s.shape).astype(np.float32)
            for s in j_field.param_specs(j_config)]
  pred = rng.normal(size=(MEMBERS, y.shape[0])).astype(np.float32)
  weights = (rng.uniform(size=y.shape[0]) > 0.3).astype(np.float32)
  for w in (None, weights):
    want = jax.vmap(
        lambda p, pr: j_likelihoods.log_likelihood(
            NORMAL_J, p, pr, y, weights=w))(
                tuple(jnp.asarray(p) for p in params), pred)
    got = t_likelihoods.log_likelihood(
        NORMAL_T, tuple(torch.as_tensor(p) for p in params),
        torch.as_tensor(pred), torch.as_tensor(y),
        weights=None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize('groups', [None, 1, 2, 4], ids=[
    'shared', 'one-group', 'grouped-rep2', 'per-member'])
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_log_likelihood_matches_jax(distribution, groups):
  """NB and ZINB log-likelihood sums against the JAX package's, rtol 1e-5,
  for targets shared by every member or grouped (member m reads group m //
  (E / G)), weighted and not; preds reach the log-softplus clamp."""
  members, n = 4, 70
  rng = np.random.default_rng(5)
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  params = [rng.normal(size=(members,) + s.shape).astype(np.float32)
            for s in j_field.param_specs(j_config)]
  pred = rng.normal(scale=4.0, size=(members, n)).astype(np.float32)
  pred[:, :3] = (-30.0, -18.0, 25.0)
  y = _counts_for(rng, (n,) if groups is None else (groups, n))
  weights = (rng.uniform(size=n) > 0.3).astype(np.float32)
  y_members = y if groups is None else y[np.arange(members) // (
      members // groups)]
  dist_j = j_likelihoods.LikelihoodDist(distribution)
  for w in (None, weights):
    want = jax.vmap(
        lambda p, pr, yy: j_likelihoods.log_likelihood(
            dist_j, p, pr, yy, weights=w),
        in_axes=(0, 0, None if groups is None else 0))(
            tuple(jnp.asarray(p) for p in params), pred, y_members)
    got = t_likelihoods.log_likelihood(
        t_likelihoods.LikelihoodDist(distribution),
        tuple(torch.as_tensor(p) for p in params), torch.as_tensor(pred),
        torch.as_tensor(y), weights=None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _counts_for(rng, shape):
  y = rng.poisson(rng.gamma(2.0, 4.0, size=shape)).astype(np.float32)
  y.reshape(-1)[::7] = 0.0
  return y


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
@pytest.mark.parametrize('backend,row_chunk', [
    ('torch', t_map.ROW_CHUNK), ('torch', 32), ('kernel', t_map.ROW_CHUNK),
], ids=['torch', 'torch-chunked', 'kernel-path'])
def test_first_step_matches_value_and_grad(prior_weight, backend, row_chunk,
                                           monkeypatch):
  # On CPU tensors the 'kernel' step function calls `fused_train`, which
  # computes the plain version (and counts no launch): this runs the kernel
  # path's scatter and prior bookkeeping.
  monkeypatch.setattr(t_map, 'ROW_CHUNK', row_chunk)
  j_config, t_config, aug, y = _data()
  _, params = _jax_init(j_config, y)
  d = j_config.num_inputs
  aug_t = jnp.asarray(aug.T)

  def loss(p):
    pred = j_field.apply_field_t(j_config, p, aug_t[:d], aug_t[d:])
    out = -j_likelihoods.log_likelihood(NORMAL_J, p, pred, jnp.asarray(y))
    if prior_weight:
      out = out - prior_weight * j_priors.prior_log_prob(j_config, p)
    return out

  want_losses, want_grads = jax.vmap(jax.value_and_grad(loss))(
      tuple(jnp.asarray(p) for p in params))
  step = t_map.make_losses_and_grads(t_config, NORMAL_T, prior_weight,
                                     backend)
  launches = t_fused.fused_train.launches
  losses, grads = step(tuple(torch.as_tensor(p) for p in params),
                       torch.as_tensor(aug.T[:d].copy()),
                       torch.as_tensor(aug.T[d:].copy()), torch.as_tensor(y))
  assert t_fused.fused_train.launches == launches
  np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                             rtol=STEP_LOSS_RTOL)
  for i, (g, w) in enumerate(zip(grads, want_grads)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP_GRAD_TOL,
                               err_msg=f'slot {i}')


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
def test_train_matches_ensemble_map(prior_weight):
  j_config, t_config, aug, y = _data()
  mesh, params0 = _jax_init(j_config, y)
  epochs = 20
  want_params, want_losses = j_map.ensemble_map(
      aug, y, j_config, NORMAL_J, MEMBERS, LR, epochs,
      jax.random.PRNGKey(0), prior_weight=prior_weight, mesh=mesh,
      backend='xla')
  t_params = tuple(torch.as_tensor(p) for p in params0)
  got_params, state, got_losses = t_map.train(
      t_params, t_map.init_opt_state(t_params),
      torch.as_tensor(aug.T.copy()), torch.as_tensor(y), t_config, NORMAL_T,
      LR, epochs, prior_weight=prior_weight, backend='torch')
  assert state.count == epochs
  assert got_losses.shape == (MEMBERS, epochs)
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_minibatch_train_matches_ensemble_map(prior_weight, backend):
  j_config, t_config, aug, y = _data()
  mesh, params0, keys = _jax_init(j_config, y, with_keys=True)
  epochs, batch = 6, 20  # 3 steps per epoch; 10 rows dropped each epoch.
  want_params, want_losses = j_map.ensemble_map(
      aug, y, j_config, NORMAL_J, MEMBERS, LR, epochs,
      jax.random.PRNGKey(0), batch_size=batch, prior_weight=prior_weight,
      mesh=mesh, backend='xla')
  perms = _jax_permutations(keys, y.shape[0], epochs)
  t_params = tuple(torch.as_tensor(p) for p in params0)
  launches = t_fused.fused_train.launches
  got_params, state, got_losses = t_map.train(
      t_params, t_map.init_opt_state(t_params),
      torch.as_tensor(aug.T.copy()), torch.as_tensor(y), t_config, NORMAL_T,
      LR, epochs, prior_weight=prior_weight, backend=backend,
      batch_size=batch, permutations=lambda e: torch.as_tensor(perms[e]))
  assert t_fused.fused_train.launches == launches  # CPU: no launches
  assert state.count == 3 * epochs
  assert got_losses.shape == (MEMBERS, epochs)
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


def test_random_permutations_and_batches():
  generator = torch.Generator().manual_seed(3)
  perms = t_map.random_permutations(generator, 4, 9)
  assert perms.shape == (4, 9)
  assert all(sorted(p.tolist()) == list(range(9)) for p in perms)
  assert len({tuple(p.tolist()) for p in perms}) > 1
  x_t = torch.arange(18.0).reshape(2, 9)
  s_t = -torch.arange(27.0).reshape(3, 9)
  y = torch.arange(9.0) * 10
  xb, sb, yb = t_map.gather_batch(x_t, s_t, y, perms[:, :5])
  assert (xb.shape, sb.shape, yb.shape) == ((4, 2, 5), (4, 3, 5), (4, 5))
  assert xb.is_contiguous() and sb.is_contiguous()
  assert torch.equal(xb[1], x_t[:, perms[1, :5]])
  assert torch.equal(yb[2], y[perms[2, :5]])
  assert t_map.stream_seed(7, 1) != t_map.stream_seed(7, 2)
  assert t_map.stream_seed(7, 1) == t_map.stream_seed(7, 1) < 2**63


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


@pytest.mark.parametrize('cls', ['BayesianNeuralFieldMAP',
                                 'BayesianNeuralFieldMLE'])
def test_fit_predicts_and_saves_for_jax(cls, tmp_path):
  est = getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS)
  table = _table()
  assert est.fit(table, seed=0, ensemble_size=3, num_epochs=30,
                 device='cpu') is est
  assert all(p.shape[:2] == (1, 3) and p.device.type == 'cpu'
             for p in est.params_)
  assert est.losses_.shape == (1, 3, 30)
  assert np.isfinite(est.losses_).all()
  assert (est.losses_[..., -1] < est.losses_[..., 0]).all()
  # The noise scale starts at log(nanstd(y) / 2), in float32.
  y = est.data_handler.get_target(table)
  assert est._prior_weight == (1.0 if cls.endswith('MAP') else 0.0)  # pylint: disable=protected-access
  again = getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=3, num_epochs=0, device='cpu')
  np.testing.assert_array_equal(
      again.params_[0].numpy(),
      np.full((1, 3), np.float32(np.log(np.nanstd(y) / 2.0))))

  new = _table(n_hours=30, seed=1)
  means, quantiles = est.predict(new, quantiles=(0.5, 0.9))
  assert means.shape == (1, 3, len(new))
  path = tmp_path / 'fit.npz'
  est.save(str(path))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(str(path))
  assert type(back).__name__ == cls
  want_means, want_q = back.predict(new, quantiles=(0.5, 0.9), backend='xla')
  np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                             rtol=2e-5, atol=1e-4)
  noise = 0.01 + np.exp(est.params_[0].numpy().max())
  for g, w in zip(quantiles, want_q):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                               atol=1e-4 * noise)


def test_same_seed_same_fit_and_splits():
  table = _table()
  fits = [bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, seed=7, ensemble_size=4, num_epochs=3, device='cpu',
      num_splits=splits) for splits in (1, 1, 2)]
  for a, b in zip(fits[0].params_, fits[1].params_):
    assert torch.equal(a, b)
  np.testing.assert_array_equal(fits[0].losses_, fits[1].losses_)
  assert fits[2].losses_.shape == (1, 4, 3)
  assert t_map.split_seed(7, 0, 1) == 7
  assert len({t_map.split_seed(7, i, 2) for i in range(2)}) == 2
  assert not torch.equal(fits[0].params_[7], fits[2].params_[7])


@pytest.mark.parametrize('cls', ['map', 'mle'])
def test_chickenpox_mini_golden(cls):
  """The RNG-independent assertions of test_golden_mini_parity.py:86-121 on
  the training rows: 4 particles x 5 epochs, lr 0.005."""
  data = registry.dataset_config('chickenpox')
  kwargs = dict(registry.model_config('chickenpox', cls))
  kwargs.update(feature_cols=data['feature_cols'],
                target_col=data['target_col'], timetype=data['timetype'],
                freq=data['freq'], standardize=data['standardize'])
  est_cls = {'map': bayesnf_torch.BayesianNeuralFieldMAP,
             'mle': bayesnf_torch.BayesianNeuralFieldMLE}[cls]
  train = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  est = est_cls(**kwargs).fit(train, seed=0, ensemble_size=4, num_epochs=5,
                              learning_rate=0.005, device='cpu')
  means, (p50, lower, upper) = est.predict(
      train, quantiles=(0.5, 0.025, 0.975))
  golden = pd.read_csv(DATA / f'bnf-{cls}.chickenpox.8.mini.pred.csv',
                       index_col=0).loc[train.index]
  np.testing.assert_allclose((upper - lower).numpy(),
                             (golden.yhat_upper - golden.yhat_lower).values,
                             rtol=0.02)
  yhat = means.mean(dim=(0, 1)).numpy()
  assert np.abs(yhat).max() < 2.0
  assert np.abs(p50.numpy() - yhat).max() < 1.0


@pytest.mark.parametrize('cls', ['BayesianNeuralFieldMAP',
                                 'BayesianNeuralFieldMLE'])
def test_minibatch_fit_takes_n_over_b_steps_per_epoch(cls):
  table = _table()  # 96 rows: 3 steps of 30, 6 rows dropped, per epoch.
  est = getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS)
  est.fit(table, seed=0, ensemble_size=3, num_epochs=8, batch_size=30,
          device='cpu')
  assert est.losses_.shape == (1, 3, 8)
  assert np.isfinite(est.losses_).all()
  assert (est.losses_[..., -3:].mean(-1) < est.losses_[..., :3].mean(-1)).all()
  again = getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=3, num_epochs=8, batch_size=30,
      device='cpu')
  np.testing.assert_array_equal(est.losses_, again.losses_)
  other = getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS).fit(
      table, seed=1, ensemble_size=3, num_epochs=8, batch_size=30,
      device='cpu')
  assert not np.array_equal(est.losses_, other.losses_)
  means, _ = est.predict(table, quantiles=(0.5,))
  assert means.shape == (1, 3, len(table))


@pytest.mark.parametrize('change,error,match', [
    # A mesh, checkpoints and streaming are ported (tests/test_torch_
    # parallel.py, test_torch_checkpoint.py, test_torch_streaming.py); what
    # `fit` refuses: a mesh that is not the port's `Mesh`, a remote
    # checkpoint directory (local only, unlike the JAX package), and, as
    # the JAX package, streaming a full batch.
    (dict(mesh=object()), TypeError, 'bayesnf_torch.parallel.mesh.Mesh'),
    (dict(checkpoint_dir='gs://bucket/ckpt'), ValueError, 'remote URI'),
    (dict(stream_chunk_steps=4), ValueError, 'requires minibatch'),
], ids=['mesh', 'checkpoint', 'stream'])
def test_fit_refuses_what_is_not_ported(change, error, match):
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS)
  with pytest.raises(error, match=match):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            **change)


def test_fit_device_and_backend_checks(monkeypatch):
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS)
  with pytest.raises(ValueError, match='CUDA device'):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            backend='kernel')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1)
  # A full batch given explicitly, or larger than the table, trains.
  est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
          batch_size=10_000)
  assert est.losses_.shape == (1, 2, 1)


@pytest.mark.parametrize('batch,backend', [
    (None, 'torch'), (20, 'torch'), (20, 'kernel'),
], ids=['full', 'minibatch', 'minibatch-kernel-path'])
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_train_matches_ensemble_map(distribution, batch, backend):
  """MAP trajectories of the count models against `ensemble_map(xla)` from
  the JAX package's initial parameters, at the NORMAL bounds."""
  j_config, t_config, aug, y = _data()
  counts = _count_targets(y, distribution)
  mesh, params0, keys = _jax_init(j_config, counts, with_keys=True)
  epochs = 10 if batch is None else 4
  want_params, want_losses = j_map.ensemble_map(
      aug, counts, j_config, j_likelihoods.LikelihoodDist(distribution),
      MEMBERS, LR, epochs, jax.random.PRNGKey(0), batch_size=batch,
      mesh=mesh, backend='xla')
  perms = _jax_permutations(keys, y.shape[0], epochs)
  t_params = tuple(torch.as_tensor(p) for p in params0)
  got_params, _, got_losses = t_map.train(
      t_params, t_map.init_opt_state(t_params),
      torch.as_tensor(aug.T.copy()), torch.as_tensor(counts), t_config,
      t_likelihoods.LikelihoodDist(distribution), LR, epochs,
      backend=backend, batch_size=batch,
      permutations=lambda e: torch.as_tensor(perms[e]))
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


def _count_table(distribution, n_hours=24, seed=0):
  table = _table(n_hours=n_hours, seed=seed)
  table['y'] = _count_targets(table['y'].to_numpy(), distribution, seed)
  return table


@pytest.mark.parametrize('cls', ['BayesianNeuralFieldMAP',
                                 'BayesianNeuralFieldMLE'])
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_fit_predicts_and_saves_for_jax(distribution, cls, tmp_path):
  """A count model fitted here, full batch then minibatch, predicts integer
  quantiles, and its artifact predicts the same in the JAX package: means
  rtol 2e-5 / atol 1e-4, quantiles within one count on at most max(1, 1%)
  of the rows."""
  kwargs = dict(ESTIMATOR_KWARGS, observation_model=distribution)
  table = _count_table(distribution)
  est = getattr(bayesnf_torch, cls)(**kwargs).fit(
      table, seed=0, ensemble_size=3, num_epochs=20, device='cpu')
  assert est.losses_.shape == (1, 3, 20)
  assert np.isfinite(est.losses_).all()
  assert (est.losses_[..., -1] < est.losses_[..., 0]).all()
  est.fit(table, seed=1, ensemble_size=3, num_epochs=2, batch_size=30,
          device='cpu')
  assert est.losses_.shape == (1, 3, 2) and np.isfinite(est.losses_).all()
  new = _count_table(distribution, n_hours=30, seed=1)
  means, quantiles = est.predict(new, quantiles=(0.5, 0.9))
  assert means.shape == (1, 3, len(new))
  for q in quantiles:
    assert q.shape == (len(new),) and torch.equal(q, torch.round(q))
    assert bool((q >= 0).all())
  path = tmp_path / 'fit.npz'
  est.save(str(path))
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(str(path))
  assert type(back).__name__ == cls
  assert back.observation_model == distribution
  want_means, want_q = back.predict(new, quantiles=(0.5, 0.9), backend='xla')
  np.testing.assert_allclose(means.numpy(), np.asarray(want_means),
                             rtol=2e-5, atol=1e-4)
  for g, w in zip(quantiles, want_q):
    off = np.abs(g.numpy() - np.asarray(w))
    assert off.max() <= 1.0, off.max()
    assert (off > 0).sum() <= max(1, len(new) // 100), (off > 0).sum()


# 'bf16' against the JAX package's 'bf16': both round the same fp32 values,
# but values an ulp apart can round to neighbouring bf16 values, so losses
# rtol 1e-3 and each leaf within 2e-3 of its largest magnitude (the JAX
# package's count bounds), for one step's gradients and for the parameters
# after a few epochs alike.
BF16_LOSS_RTOL = 1e-3
BF16_LEAF_TOL = 2e-3


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
def test_bf16_first_step_matches_value_and_grad(prior_weight):
  # The 'torch' backend rounds where the JAX package's XLA path does
  # (`apply_field_t(compute_dtype=bfloat16)`): every dense product.
  j_config, t_config, aug, y = _data()
  _, params = _jax_init(j_config, y)
  d = j_config.num_inputs
  aug_t = jnp.asarray(aug.T)

  def loss(p):
    pred = j_field.apply_field_t(j_config, p, aug_t[:d], aug_t[d:],
                                 compute_dtype=jnp.bfloat16)
    out = -j_likelihoods.log_likelihood(NORMAL_J, p, pred, jnp.asarray(y))
    if prior_weight:
      out = out - prior_weight * j_priors.prior_log_prob(j_config, p)
    return out

  want_losses, want_grads = jax.vmap(jax.value_and_grad(loss))(
      tuple(jnp.asarray(p) for p in params))
  step = t_map.make_losses_and_grads(t_config, NORMAL_T, prior_weight,
                                     'torch', precision='bf16')
  losses, grads = step(tuple(torch.as_tensor(p) for p in params),
                       torch.as_tensor(aug.T[:d].copy()),
                       torch.as_tensor(aug.T[d:].copy()), torch.as_tensor(y))
  np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                             rtol=BF16_LOSS_RTOL)
  _leaf_close([g.numpy() for g in grads], want_grads, BF16_LEAF_TOL, 'grads')


def _jax_xla_bf16_train(config, aug, target, params, distribution, epochs,
                        batch, perms):
  """`ensemble_map(backend='xla', precision='bf16')`'s epochs, stepped
  eagerly: the same per-member loss (`apply_field_t(compute_dtype=
  bfloat16)`, likelihood, prior) and `optax.adam`. XLA:CPU cannot run the
  jitted program (its DotThunk has no BF16 x BF16 = F32 dot), while each
  operation dispatched on its own runs."""
  d, n = config.num_inputs, target.shape[0]
  batch = batch or n
  dist = j_likelihoods.LikelihoodDist(distribution)

  def loss(p, aug_t, y):
    pred = j_field.apply_field_t(config, p, aug_t[:d], aug_t[d:],
                                 compute_dtype=jnp.bfloat16)
    return (-(n / batch) * j_likelihoods.log_likelihood(dist, p, pred, y)
            - j_priors.prior_log_prob(config, p))

  opt = optax.adam(LR)
  params = tuple(jnp.asarray(p) for p in params)
  state = opt.init(params)
  history = []
  for epoch in range(epochs):
    if batch == n:
      batches, axes = [(jnp.asarray(aug.T), jnp.asarray(target))], None
    else:
      keep, axes = perms[epoch], 0
      batches = [(jnp.asarray(np.stack([aug[r].T for r in rows])),
                  jnp.asarray(target[rows]))
                 for rows in (keep[:, j * batch:(j + 1) * batch]
                              for j in range(n // batch))]
    step_losses = []
    for aug_b, y_b in batches:
      losses, grads = jax.vmap(jax.value_and_grad(loss),
                               in_axes=(0, axes, axes))(params, aug_b, y_b)
      updates, state = opt.update(grads, state)
      params = optax.apply_updates(params, updates)
      step_losses.append(np.asarray(losses))
    history.append(np.mean(step_losses, axis=0))
  return params, np.stack(history, axis=1)


# After a few Adam epochs a parameter entry whose gradient the two sides
# round differently moves by a fraction of one step (lr): the parameters are
# held to 2e-3 of each leaf's largest magnitude plus 5% of lr (the largest
# difference seen is 1.6% of lr, in a ZINB feature scale).
BF16_STEP_TOL = 0.05 * LR


@pytest.mark.parametrize('batch', [None, 20], ids=['full', 'minibatch'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_bf16_train_matches_jax(distribution, backend, batch):
  """A few 'bf16' epochs from the JAX package's initial parameters and
  permutations: 'torch' against the XLA path's loss under `optax.adam`
  (`_jax_xla_bf16_train`), the CPU kernel path (the plain K1, rounding where
  K1 rounds) against `ensemble_map(backend='pallas', precision='bf16')`
  (the Pallas kernel, interpreted)."""
  j_config, t_config, aug, y = _data()
  target = y if distribution == 'NORMAL' else _count_targets(y, distribution)
  mesh, params0, keys = _jax_init(j_config, target, with_keys=True)
  epochs = 4 if batch is None else 2
  perms = _jax_permutations(keys, y.shape[0], epochs)
  if backend == 'torch':
    want_params, want_losses = _jax_xla_bf16_train(
        j_config, aug, target, params0, distribution, epochs, batch, perms)
  else:
    want_params, want_losses = j_map.ensemble_map(
        aug, target, j_config, j_likelihoods.LikelihoodDist(distribution),
        MEMBERS, LR, epochs, jax.random.PRNGKey(0), batch_size=batch,
        mesh=mesh, precision='bf16', backend='pallas')
  t_params = tuple(torch.as_tensor(p) for p in params0)
  got_params, _, got_losses = t_map.train(
      t_params, t_map.init_opt_state(t_params),
      torch.as_tensor(aug.T.copy()), torch.as_tensor(target), t_config,
      t_likelihoods.LikelihoodDist(distribution), LR, epochs,
      backend=backend, batch_size=batch,
      permutations=lambda e: torch.as_tensor(perms[e]), precision='bf16')
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=BF16_LOSS_RTOL)
  for i, (g, w) in enumerate(zip(got_params, want_params)):
    w = np.asarray(w)
    bound = BF16_LEAF_TOL * np.abs(w).max() + BF16_STEP_TOL
    assert np.abs(g.numpy() - w).max() <= bound, (i, np.abs(g.numpy() - w).max())


@pytest.mark.parametrize('precision', ['bf16', 'highest'])
@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
@pytest.mark.parametrize('cls', ['BayesianNeuralFieldMAP',
                                 'BayesianNeuralFieldMLE'])
def test_precision_plumbs_through_fit(cls, batch_size, precision):
  table = _table()
  fits = [getattr(bayesnf_torch, cls)(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=3, num_epochs=4, batch_size=batch_size,
      device='cpu', precision=p) for p in (precision, 'f32')]
  assert np.isfinite(fits[0].losses_).all()
  if precision == 'highest':
    np.testing.assert_array_equal(fits[0].losses_, fits[1].losses_)
    assert all(torch.equal(a, b) for a, b in zip(fits[0].params_,
                                                 fits[1].params_))
  else:
    assert not np.array_equal(fits[0].losses_, fits[1].losses_)
    np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=2e-2)


def test_unknown_precision_raises():
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS)
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    est.fit(_table(), seed=0, ensemble_size=2, num_epochs=1, device='cpu',
            precision='fp16')
  _, t_config, aug, y = _data()
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    t_map.ensemble_map(aug, y, t_config, NORMAL_T, 2, LR, 1, 0,
                       device='cpu', precision='fp16')
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    t_map.make_nll_and_grads(None, NORMAL_T, 1.0, 'torch', 'fp16')


@pytest.mark.parametrize('precision', ['f32', 'highest', 'bf16'])
@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
def test_fit_products_run_in_fp32_whatever_tf32(precision, batch_size,
                                                monkeypatch):
  # A caller who allowed TF32 gets it back after the fit, and the fit's
  # products ran without it ('bf16' too: its exact products are fp32 ones).
  seen = []
  matmul = torch.matmul

  def spy(*args, **kwargs):
    seen.append((torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision()))
    return matmul(*args, **kwargs)

  monkeypatch.setattr(torch, 'matmul', spy)
  saved = torch.get_float32_matmul_precision()
  try:
    torch.backends.cuda.matmul.allow_tf32 = True
    bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
        _table(), seed=0, ensemble_size=2, num_epochs=2, device='cpu',
        batch_size=batch_size, precision=precision)
    assert torch.backends.cuda.matmul.allow_tf32
  finally:
    torch.set_float32_matmul_precision(saved)
  assert seen and set(seen) == {(False, 'highest')}
