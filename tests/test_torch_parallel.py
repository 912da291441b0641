"""The port's device mesh (`bayesnf_torch.parallel`), and the fits, K1's
valid-row count (stage 4) and the predict over it, against `bayesnf_tpu`.

The port's meshes here are grids of 'cpu' entries (a mesh may repeat a
device), the JAX package's the conftest's virtual CPU devices. Both sides
start from the same numpy parameters (the JAX package's own init on its
mesh) and see the same permutations and Monte-Carlo noise (the JAX
package's, injected into the port):

- the row layout and minibatch helpers equal their JAX counterparts, and
  `default_mesh` refuses what the JAX one refuses;
- K1's plain version with `n_valid` over junk-padded rows against the JAX
  kernel with `n_valid` (Pallas interpret mode) at the bounds of
  `test_torch_fused_train.py`, and bit for bit equal to the plain version
  on the unpadded rows (junk NaN included);
- full-batch MAP and MLE fits over an uneven data axis (70 rows: 24 / 23 /
  23), a divisible minibatch over two shards, and a full-batch VI fit over
  three, each against the JAX package's fit over the same mesh, at the
  trajectory bounds of `test_torch_map.py` (losses rtol 1e-5, parameters 1e-4
  of each leaf's largest magnitude);
- member padding over 'ens', the estimator's group shapes, the row-parallel
  predict, and artifacts of mesh fits crossing between the packages;
- the 'auto' backend picks 'torch', before any launch, for a model K1 does
  not take, where explicit 'kernel' still raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.inference import backends as t_backends
from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import predict as t_predict
from bayesnf_torch.inference import vi as t_vi
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_torch.parallel import mesh as t_mesh
from bayesnf_torch.parallel import minibatch as t_minibatch
import bayesnf_tpu
from bayesnf_tpu.inference import map as j_map
from bayesnf_tpu.inference import vi as j_vi
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import likelihoods as j_likelihoods
from bayesnf_tpu.ops import fused_mlp as j_fused
from bayesnf_tpu.parallel import mesh as j_mesh
from bayesnf_tpu.parallel import minibatch as j_minibatch

torch.set_num_threads(1)

NORMAL_J = j_likelihoods.LikelihoodDist.NORMAL
NORMAL_T = t_likelihoods.LikelihoodDist.NORMAL
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_TOL = 1e-4
MEMBERS = 3
LR = 0.005
N_ROWS = 70  # 24 / 23 / 23 over three data shards.
CONFIG_KWARGS = dict(
    width=16, depth=2, input_scales=[50.0, 1.0, 1.0],
    fourier_degrees=[3, 2, 0], interactions=[(0, 1), (1, 2)],
    seasonality_periods=[7.0], num_seasonal_harmonics=[2])
# Means against the JAX package and between meshes (tests/test_torch_map.py).
MEANS_TOL = dict(rtol=2e-5, atol=1e-4)


def _data(n=N_ROWS, seed=0):
  """(JAX config, port config, aug (N, D + 2F), target (N,)) as numpy."""
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  t_config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  rng = np.random.default_rng(seed)
  x = (rng.normal(size=(n, 3)) * 5).astype(np.float32)
  y = (np.sin(x[:, 0]) + x[:, 1] + 0.3 * rng.normal(size=n)).astype(
      np.float32)
  aug = np.array(j_field.aug_features_device(j_config, x))
  return j_config, t_config, aug, y


def _meshes(ens, data):
  """(JAX mesh on the conftest's virtual devices, port mesh of 'cpu'
  entries), both (ens, data)."""
  return (j_mesh.default_mesh(jax.devices()[:ens * data], ensemble_devices=ens,
                              data_devices=data),
          t_mesh.default_mesh(['cpu'] * (ens * data), ensemble_devices=ens,
                              data_devices=data))


def _leaf_close(got, want, tol, what):
  for i, (g, w) in enumerate(zip(got, want)):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (what, i)
    bound = tol * max(np.abs(w).max(), np.finfo(np.float32).tiny)
    assert np.abs(g - w).max() <= bound, (what, i, np.abs(g - w).max(), bound)


# --- The mesh and the row layout ------------------------------------------


def test_default_mesh_and_its_errors(monkeypatch):
  cpus = ['cpu'] * 8
  assert t_mesh.default_mesh(cpus).shape == {'ens': 8, 'data': 1}
  mesh = t_mesh.default_mesh(cpus, data_devices=4)
  assert mesh.shape == {'ens': 2, 'data': 4} == dict(
      j_mesh.default_mesh(jax.devices()[:8], data_devices=4).shape)
  assert mesh.size == 8 and mesh.devices[1][3] == torch.device('cpu')
  assert mesh.first_device == torch.device('cpu')
  with pytest.raises(ValueError):
    t_mesh.default_mesh(cpus, data_devices=3)
  with pytest.raises(ValueError):
    t_mesh.default_mesh(cpus, ensemble_devices=3, data_devices=2)
  full = t_mesh.default_mesh(cpus)
  for members, padded in ((8, 8), (3, 8), (9, 16), (1, 8)):
    assert t_mesh.pad_ensemble_size(members, full) == padded
    assert t_mesh.pad_ensemble_size(members, full) == j_mesh.pad_ensemble_size(
        members, j_mesh.default_mesh(jax.devices()[:8]))
  with pytest.raises(ValueError, match='rectangular'):
    t_mesh.Mesh([['cpu'], []])
  with pytest.raises(ValueError, match='one type'):
    _ = t_mesh.Mesh([['cpu', 'meta']]).device_type
  with pytest.raises(TypeError, match='Mesh'):
    t_mesh.check_mesh(j_mesh.default_mesh(jax.devices()[:1]))
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
  with pytest.raises(ValueError, match='No CUDA device'):
    t_mesh.default_mesh()


@pytest.mark.parametrize('n,shards', [(70, 3), (97, 2), (7, 4), (96, 1)])
def test_row_layout_helpers_match_jax(n, shards):
  assert t_minibatch.shard_counts(n, shards) == j_minibatch.shard_counts(
      n, shards)
  rng = np.random.default_rng(n)
  aug_t = rng.normal(size=(5, n)).astype(np.float32)
  y = rng.normal(size=n).astype(np.float32)
  got = t_minibatch.pad_rows_balanced(torch.as_tensor(aug_t),
                                      torch.as_tensor(y), n, shards)
  want = j_minibatch.pad_rows_balanced(jnp.asarray(aug_t), jnp.asarray(y), n,
                                       shards)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  np.testing.assert_array_equal(
      t_minibatch.valid_row_weights(n, shards).numpy(),
      np.asarray(j_minibatch.valid_row_weights(n, shards)))
  np.testing.assert_array_equal(t_minibatch.stored_positions(n, shards),
                                j_minibatch.stored_positions(n, shards))
  local_rows, counts = t_minibatch.shard_counts(n, shards)
  for s, n_s in enumerate(counts):
    assert t_minibatch.local_valid_count(n, shards, s) == n_s == int(
        j_minibatch.local_valid_count(n, shards, jnp.int32(s)))
    # The local permutation, from the JAX package's uniforms.
    key = jax.random.PRNGKey(s + 3)
    count = max(1, n_s - 2)
    want = j_minibatch.local_permutation(key, s, local_rows, n_s, count)
    u = jax.random.uniform(jax.random.fold_in(key, s), (local_rows,))
    got = t_minibatch.local_permutation(
        torch.as_tensor(np.array(u))[None], n_s, count)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shard_rows_places_each_shard_once_per_device():
  _, t_config, aug, y = _data()
  mesh = t_mesh.default_mesh(['cpu', 'meta'] * 3, ensemble_devices=3,
                             data_devices=2)
  rows = t_minibatch.shard_rows(torch.as_tensor(aug.T.copy()),
                                torch.as_tensor(y), mesh, 3)
  assert [[r.y.device.type for r in row] for row in rows] == [
      ['cpu', 'meta']] * 3
  assert rows[0][0] is rows[2][0] and rows[1][1] is rows[0][1]
  assert rows[0][0].n_valid is None  # 70 rows: 35 / 35, no padding.
  np.testing.assert_array_equal(rows[0][0].x_t.numpy(), aug.T[:3, :35])
  one = t_minibatch.shard_rows(torch.as_tensor(aug.T.copy()),
                               torch.as_tensor(y), t_mesh.Mesh([['cpu']]), 3)
  assert one[0][0].x_t.is_contiguous() and one[0][0].y.shape == (N_ROWS,)


# --- K1 stage 4: the valid-row count --------------------------------------

TILE = 32
LIK_SCALE = 1.25
K1_BOUNDS = {
    # Stage 1's bounds; the count models' against the Pallas kernel, whose
    # Stirling log-gamma differs from the exact one by up to ~3e-4.
    'NORMAL': (2e-4, dict(rtol=2e-4, atol=2e-5)),
    'NB': (1e-3, dict(rtol=2e-3, atol=2e-4)),
    'ZINB': (1e-3, dict(rtol=2e-3, atol=2e-4)),
}
JUNK = 13


def _k1_inputs(distribution, members=3, seed=3):
  """(JAX config, numpy params, x_t (D, N), seasonal_t (2F, N), y (N,)) at
  depth 2 with seasonal rows and interactions; count targets for NB/ZINB."""
  config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  rng = np.random.default_rng(seed)
  params = []
  for spec in j_field.param_specs(config):
    shape = (members,) + spec.shape
    draw = (np.clip(rng.normal(size=shape), -2, 2) if spec.is_matrix
            else 0.1 * rng.normal(size=shape))
    params.append(draw.astype(np.float32))
  x = (rng.normal(size=(N_ROWS, 3)) * 5).astype(np.float32)
  seasonal_t = np.array(np.asarray(j_field.seasonal_features_for(
      config, jnp.asarray(x))).T, dtype=np.float32, order='C')
  if distribution == 'NORMAL':
    y = rng.normal(size=N_ROWS).astype(np.float32)
  else:
    y = rng.poisson(rng.gamma(2.0, 4.0, size=N_ROWS)).astype(np.float32)
    y[::7] = 0.0
  return config, params, np.ascontiguousarray(x.T), seasonal_t, y


def _k1_args(config, params, x_t, seasonal_t, y, convert):
  num_w = config.depth + 1
  return dict(
      depth=config.depth, lik_scale=LIK_SCALE,
      input_scales=config.input_scales,
      fourier_degrees=config.fourier_degrees,
      interactions=config.interactions,
      x_t=convert(x_t), seasonal_t=convert(seasonal_t),
      weights=tuple(convert(params[7 + 2 * l]) for l in range(num_w)),
      biases=tuple(convert(params[8 + 2 * l]) for l in range(num_w)),
      lsa=convert(params[j_field.IDX_LOG_SCALE_ADJ]),
      fs_raw=convert(params[j_field.IDX_FEATURE_SCALES]),
      scales_raw=convert(params[j_field.IDX_LAYER_SCALES]),
      logit=convert(params[j_field.IDX_ACTIVATION_LOGIT]),
      obs_raw=convert(np.stack(params[:3], axis=-1)),
      y=convert(y),
  )


def _padded(a, value):
  return np.concatenate(
      [a, np.full(a.shape[:-1] + (JUNK,), value, np.float32)], axis=-1)


def _flat(outs):
  return [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]


@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_k1_n_valid_matches_pallas_and_the_unpadded_rows(distribution):
  config, params, x_t, seasonal_t, y = _k1_inputs(distribution)
  junk = (_padded(x_t, 9.9), _padded(seasonal_t, -9.9),
          _padded(y, 5.0 if distribution == 'NORMAL' else 17.0))
  j_args = _k1_args(config, params, *junk, jnp.asarray)
  want = j_fused.fused_train(distribution, j_args.pop('depth'), TILE,
                             **j_args, n_valid=jnp.int32(N_ROWS))
  # On CPU tensors the wrapper computes the plain version, and counts no
  # launch.
  launches = t_fused.fused_train.launches
  got = t_fused.fused_train(
      distribution, **_k1_args(config, params, *junk, torch.as_tensor),
      n_valid=N_ROWS)
  assert t_fused.fused_train.launches == launches
  loss_rtol, grad_tol = K1_BOUNDS[distribution]
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             rtol=loss_rtol)
  _, *grads = got
  _, *want_grads = want
  for g, w in zip(_flat(grads), _flat(want_grads)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **grad_tol)
  # Whatever the rows past n_valid hold, NaN too: bit for bit the call on
  # the unpadded rows.
  unpadded = t_fused.fused_train_reference(
      distribution, **_k1_args(config, params, x_t, seasonal_t, y,
                               torch.as_tensor))
  nan_junk = t_fused.fused_train_reference(
      distribution, **_k1_args(config, params, _padded(x_t, np.nan),
                               _padded(seasonal_t, np.nan),
                               _padded(y, np.nan), torch.as_tensor),
      n_valid=N_ROWS)
  for a, b, c in zip(_flat(got), _flat(unpadded), _flat(nan_junk)):
    assert torch.equal(a, b) and torch.equal(b, c)


# --- Fits over a mesh against the JAX package's ---------------------------


def _jax_init(j_config, y, mesh, members=MEMBERS):
  """The JAX package's initial ensemble and member keys on `mesh`."""
  params, _, keys, _ = j_map._make_init_fn(  # pylint: disable=protected-access
      j_config, LR, members, mesh)(jax.random.PRNGKey(0),
                                   np.float32(np.log(np.nanstd(y) / 2.0)))
  return [np.array(p) for p in params], keys


def _port_train(t_config, aug, y, params0, epochs, mesh, backend,
                prior_weight=1.0, batch_size=None, permutations=None):
  t_params = tuple(torch.as_tensor(p) for p in params0)
  return t_map.train(
      t_params, t_map.init_opt_state(t_params), torch.as_tensor(aug.T.copy()),
      torch.as_tensor(y), t_config, NORMAL_T, LR, epochs,
      prior_weight=prior_weight, backend=backend, batch_size=batch_size,
      permutations=permutations, mesh=mesh)


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
@pytest.mark.parametrize('backend,jax_backend,epochs', [
    ('torch', 'xla', 20), ('kernel', 'pallas', 3),
], ids=['torch', 'kernel-path'])
def test_full_batch_fit_over_uneven_data_shards(prior_weight, backend,
                                                jax_backend, epochs):
  """Over data=3 with 70 rows (24 / 23 / 23: two shards mask a padded row);
  the kernel path runs the plain K1 with each shard's `n_valid`, against
  the Pallas kernel's (interpret mode)."""
  j_config, t_config, aug, y = _data()
  j_mesh3, t_mesh3 = _meshes(1, 3)
  params0, _ = _jax_init(j_config, y, j_mesh3)
  want_params, want_losses = j_map.ensemble_map(
      aug, y, j_config, NORMAL_J, MEMBERS, LR, epochs, jax.random.PRNGKey(0),
      prior_weight=prior_weight, mesh=j_mesh3, backend=jax_backend)
  got_params, state, got_losses = _port_train(
      t_config, aug, y, params0, epochs, t_mesh3, backend, prior_weight)
  assert state.count == epochs and got_losses.shape == (MEMBERS, epochs)
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


def _jax_local_permutations(keys, data_size, batch, shards, epochs):
  """The per-shard local permutations of the JAX package's minibatch over a
  sharded data axis (`map._make_shardmap_train_fn`), epoch by epoch: a list
  over the shards of (E, N // B * B / shards) local positions."""
  local_rows, counts = j_minibatch.shard_counts(data_size, shards)
  count = data_size // batch * (batch // shards)
  out = []
  for _ in range(epochs):
    split = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    keys, permute_keys = split[:, 0], split[:, 1]
    out.append([np.array(jax.vmap(
        lambda k, s=s, n_s=n_s: j_minibatch.local_permutation(
            k, s, local_rows, n_s, count))(permute_keys))
                for s, n_s in enumerate(counts)])
  return out


@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_minibatch_over_two_data_shards(backend):
  """batch 20 over data=2 with 71 rows (36 / 35): each shard gives 10 rows a
  step from its own valid rows, the JAX package's local permutations
  injected; against its shard_map path ('xla', the same per-shard scheme)."""
  j_config, t_config, aug, y = _data(n=71)
  j_mesh2, t_mesh2 = _meshes(1, 2)
  params0, keys = _jax_init(j_config, y, j_mesh2)
  epochs, batch = 3, 20
  want_params, want_losses = j_map.ensemble_map(
      aug, y, j_config, NORMAL_J, MEMBERS, LR, epochs, jax.random.PRNGKey(0),
      batch_size=batch, mesh=j_mesh2, backend='xla')
  perms = _jax_local_permutations(keys, 71, batch, 2, epochs)
  got_params, state, got_losses = _port_train(
      t_config, aug, y, params0, epochs, t_mesh2, backend, batch_size=batch,
      permutations=lambda e: [torch.as_tensor(p) for p in perms[e]])
  assert state.count == 3 * epochs
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


def test_uneven_minibatch_over_data_shards():
  """A batch that does not split over the shards: 'kernel' refuses it (the
  JAX package's message); 'torch' takes the one-shard global permutation
  through the stored layout and equals the meshless fit of the same
  permutations."""
  _, t_config, aug, y = _data(n=71)
  _, t_mesh2 = _meshes(1, 2)
  params0 = [p.numpy() for p in t_map.init_ensemble(
      t_config, MEMBERS, 0, float(np.log(np.nanstd(y) / 2.0)), 'cpu')]
  rng = np.random.default_rng(1)
  perms = [torch.as_tensor(np.stack([rng.permutation(71)
                                     for _ in range(MEMBERS)]))
           for _ in range(2)]
  with pytest.raises(ValueError, match='data_shards == 0'):
    _port_train(t_config, aug, y, params0, 2, t_mesh2, 'kernel',
                batch_size=33, permutations=lambda e: perms[e])
  got = _port_train(t_config, aug, y, params0, 2, t_mesh2, 'torch',
                    batch_size=33, permutations=lambda e: perms[e])
  want = _port_train(t_config, aug, y, params0, 2, None, 'torch',
                     batch_size=33, permutations=lambda e: perms[e])
  np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-6)
  _leaf_close([p.numpy() for p in got[0]], [p.numpy() for p in want[0]],
              1e-5, 'params')


def _jax_vi_noise(config, keys, steps, samples):
  """The Monte-Carlo noise of the JAX package's VI steps: per member, each
  step splits its key in 3 and samples with the second
  (`vi._surrogate_sample`: one key per leaf, normal (S,) + leaf shape)."""
  specs = j_field.param_specs(config)
  out = []
  for _ in range(steps):
    split = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    keys, sample_keys = split[:, 0], split[:, 1]
    leaf_keys = jax.vmap(lambda k: jax.random.split(k, len(specs)))(
        sample_keys)
    out.append(tuple(torch.as_tensor(np.array(jax.vmap(
        lambda k, shape=spec.shape: jax.random.normal(
            k, (samples,) + shape))(leaf_keys[:, l])))
                     for l, spec in enumerate(specs)))
  return out


@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_vi_full_batch_over_uneven_data_shards(backend):
  """VI over data=3 (70 rows): every shard of a member sees the same draws
  (the JAX package's, injected); log q and the prior count once. Against
  `fit_vi(mesh=...)` on 'xla'."""
  j_config, t_config, aug, y = _data()
  j_mesh3, t_mesh3 = _meshes(1, 3)
  steps, samples, kl_weight = 3, 2, 0.3
  want_surrogate, want_losses, _ = j_vi.fit_vi(
      aug, y, jax.random.PRNGKey(0), 'NORMAL', j_config, MEMBERS, LR, steps,
      sample_size_divergence=samples, sample_size_posterior=1,
      kl_weight=kl_weight, mesh=j_mesh3, backend='xla')
  surrogate0, _, keys, _ = j_vi._make_vi_init_fn(  # pylint: disable=protected-access
      j_config, LR, MEMBERS, j_mesh3)(jax.random.PRNGKey(0))
  noise = _jax_vi_noise(j_config, keys, steps, samples)
  surrogate = tuple(tuple(torch.as_tensor(np.array(p)) for p in part)
                    for part in surrogate0)
  got_surrogate, _, got_losses = t_vi.train(
      surrogate, t_map.init_opt_state((*surrogate[0], *surrogate[1])),
      torch.as_tensor(aug.T.copy()), torch.as_tensor(y), t_config, NORMAL_T,
      LR, steps, N_ROWS, samples, kl_weight, torch.Generator(), backend,
      mesh=t_mesh3, noise=lambda t: noise[t])
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in (*got_surrogate[0], *got_surrogate[1])],
              [*want_surrogate[0], *want_surrogate[1]], TRAJ_PARAM_TOL,
              'surrogate')


# --- The estimator over a mesh ----------------------------------------------


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
def test_ensemble_padding_and_group_shapes(batch_size):
  """3 members over ens=2 train 4 (the padding is dropped): params_ keep
  the meshless (1, 3) shape, and each member equals the meshless fit's, bit
  for bit (the same init, and per-member permutation streams). 4 members
  over ens=2 take the group shape (2, 2)."""
  table = _table()
  kwargs = dict(seed=0, num_epochs=4, batch_size=batch_size, device='cpu')
  mesh = t_mesh.default_mesh(['cpu'] * 2)
  alone = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, ensemble_size=3, **kwargs)
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, ensemble_size=3, mesh=mesh, **kwargs)
  assert est.mesh_ is mesh and est.losses_.shape == (1, 3, 4)
  for a, b in zip(est.params_, alone.params_):
    assert a.shape[:2] == (1, 3) and torch.equal(a, b)
  np.testing.assert_array_equal(est.losses_, alone.losses_)
  four = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, ensemble_size=4, mesh=mesh, **kwargs)
  assert four.params_[7].shape[:2] == (2, 2)
  assert four.losses_.shape == (2, 2, 4)
  means, _ = four.predict(table, quantiles=(0.5,))
  assert means.shape == (2, 2, len(table))


def test_meshless_fit_keeps_one_device_where_jax_takes_every_device():
  """An intended difference (ROADMAP.md, queue 3): without a mesh the JAX
  package fits on every device (`default_mesh()`, all on 'ens'), so 8
  members over the conftest's 8 virtual CPU devices take the group shape
  (8, 1); the port fits on its one `device`, (1, 8). The port's
  `default_mesh` of 8 entries gives the JAX package's shape."""
  assert jax.device_count() == 8
  table = _table()
  kwargs = dict(seed=0, ensemble_size=8, num_epochs=2)
  j_est = bayesnf_tpu.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, backend='xla', **kwargs)
  assert all(np.shape(p)[:2] == (8, 1) for p in j_est.params_)
  alone = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, device='cpu', **kwargs)
  assert alone.mesh_ is None
  assert all(tuple(p.shape[:2]) == (1, 8) for p in alone.params_)
  assert alone.losses_.shape == (1, 8, 2)
  meshed = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, device='cpu', mesh=t_mesh.default_mesh(['cpu'] * 8), **kwargs)
  assert [tuple(p.shape) for p in meshed.params_] == [
      np.shape(p) for p in j_est.params_]
  assert meshed.losses_.shape == np.shape(j_est.losses_) == (8, 1, 2)


def test_vi_estimator_over_a_mesh():
  table = _table()
  mesh = t_mesh.default_mesh(['cpu'] * 4, data_devices=2)
  est = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=4, num_epochs=2, sample_size_posterior=3,
      sample_size_divergence=2, device='cpu', mesh=mesh)
  assert est.losses_.shape == (4, 1, 2) and np.isfinite(est.losses_).all()
  # A minibatch of 30 over the two data shards (15 rows a shard a step):
  # both backends draw the same noise and batches from one generator.
  _, t_config, aug, y = _data()
  runs = []
  for backend in ('torch', 'kernel'):
    surrogate = t_vi.init_surrogate(t_config, 4, seed=0, device='cpu')
    runs.append(t_vi.train(
        surrogate, t_map.init_opt_state((*surrogate[0], *surrogate[1])),
        torch.as_tensor(aug.T.copy()), torch.as_tensor(y), t_config,
        NORMAL_T, LR, 3, 30, 2, 0.3, torch.Generator().manual_seed(9),
        backend, mesh=mesh)[2])
  assert runs[0].shape == (4, 3) and bool(torch.isfinite(runs[0]).all())
  np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(), rtol=1e-5)
  assert est.params_[7].shape[:3] == (4, 3, 1)
  est.resample_posterior(seed=1, sample_size_posterior=5)
  assert est.params_[7].shape[:3] == (4, 5, 1)
  means, quantiles = est.predict(table, quantiles=(0.5,))
  assert means.shape == (4, 5, 1, len(table))
  assert bool(torch.isfinite(quantiles[0]).all())


def test_row_parallel_predict_matches_meshless():
  """Chunks of 32 rows round up to 36 over a (2, 3) mesh: six slices of 6
  rows, the last chunk ragged; means and quantiles as one device gives."""
  table = _table()
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=4, num_epochs=3, device='cpu')
  new = _table(n_hours=30, seed=1)
  features = est.data_handler.get_test(new)
  config = est._field_config(features.shape)  # pylint: disable=protected-access
  mesh = t_mesh.default_mesh(['cpu'] * 6, ensemble_devices=2, data_devices=3)
  want = t_predict.predict_bnf(features, 'NORMAL', est.params_, config,
                               (0.5, 0.9), chunk_size=32)
  got = t_predict.predict_bnf(features, 'NORMAL', est.params_, config,
                              (0.5, 0.9), chunk_size=32, mesh=mesh)
  np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **MEANS_TOL)
  noise = 0.01 + np.exp(est.params_[0].numpy().max())
  for g, w in zip(got[1], want[1]):
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                               atol=1e-4 * noise)
  est.mesh_ = mesh
  dist = est.likelihood_model(new)
  np.testing.assert_allclose(dist.distribution.loc.numpy(),
                             want[0].numpy(), **MEANS_TOL)


def test_mesh_fit_artifacts_cross_both_ways(tmp_path):
  """The port's fit over (1, 3) saves fit_mesh and params_ (3, 1); the JAX
  package loads it with that shape and predicts the same. A JAX fit over
  its (1, 3) mesh loads here meshless (one CPU device) with its shape."""
  table = _table()
  new = _table(n_hours=30, seed=1)
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=3, num_epochs=3, device='cpu',
      mesh=_meshes(1, 3)[1])
  assert est.params_[0].shape == (3, 1)
  path = str(tmp_path / 'port.npz')
  est.save(path)
  back = bayesnf_tpu.BayesianNeuralFieldEstimator.load(path)
  assert [np.shape(p) for p in back.params_] == [
      tuple(p.shape) for p in est.params_]
  means, _ = est.predict(new, quantiles=(0.5,))
  want, _ = back.predict(new, quantiles=(0.5,), backend='xla')
  np.testing.assert_allclose(means.numpy(), np.asarray(want), **MEANS_TOL)

  j_est = bayesnf_tpu.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table, seed=0, ensemble_size=3, num_epochs=3, mesh=_meshes(1, 3)[0],
      backend='xla')
  path = str(tmp_path / 'jax.npz')
  j_est.save(path)
  port = bayesnf_torch.BayesianNeuralFieldEstimator.load(path, device='cpu')
  assert port.mesh_ is None
  assert [tuple(p.shape) for p in port.params_] == [
      np.shape(p) for p in j_est.params_]
  means, _ = port.predict(new, quantiles=(0.5,))
  want, _ = j_est.predict(new, quantiles=(0.5,), backend='xla')
  np.testing.assert_allclose(means.numpy(), np.asarray(want), **MEANS_TOL)


# --- 'auto' decides from shapes (ROADMAP.md, queue 3, item 1) ---------------


def test_auto_backend_takes_torch_for_shapes_k1_does_not_take():
  nine = t_field.FieldConfig.create(
      width=16, depth=2, input_scales=[1.0] * 9, fourier_degrees=[1] * 9,
      interactions=[], seasonality_periods=[], num_seasonal_harmonics=[])
  # Decided from the shapes alone, before any build or launch (there is no
  # nvcc here).
  assert t_backends.resolve_backend('auto', 'cuda', nine, 'NORMAL') == 'torch'
  assert not t_backends.kernel_takes(nine, 'NORMAL')
  # Explicit 'kernel' stays 'kernel', and K1 refuses the shapes.
  assert t_backends.resolve_backend('kernel', 'cuda', nine,
                                    'NORMAL') == 'kernel'
  with pytest.raises(ValueError, match='1 to 8 inputs'):
    t_fused.check_train_shape('NORMAL', 2, 16, nine.fourier_degrees, (), 0)
  deep = t_field.FieldConfig.create(**dict(CONFIG_KWARGS, depth=9))
  assert t_backends.resolve_backend('auto', 'cuda', deep, 'NB') == 'torch'
  pairs = t_field.FieldConfig.create(**dict(
      CONFIG_KWARGS, interactions=[(0, 1)] * 33))
  assert t_backends.resolve_backend('auto', 'cuda', pairs, 'ZINB') == 'torch'
  # A sharded minibatch that does not split over the shards.
  assert t_backends.resolve_backend(
      'auto', 'cuda', data_shards=2, batch_divisible=False) == 'torch'
  assert t_backends.resolve_backend(
      'auto', 'cuda', data_shards=2, full_batch=True) == 'kernel'
  assert t_backends.resolve_backend('auto', 'cpu', nine, 'NORMAL') == 'torch'
  # On the CPU the 9-input fit runs (the plain versions).
  rng = np.random.default_rng(0)
  table = pd.DataFrame(rng.normal(size=(40, 10)),
                       columns=[f'x{i}' for i in range(9)] + ['y'])
  est = bayesnf_torch.BayesianNeuralFieldMAP(
      feature_cols=[f'x{i}' for i in range(9)], target_col='y',
      timetype='float', width=8, depth=1).fit(
          table, seed=0, ensemble_size=2, num_epochs=2, device='cpu')
  assert np.isfinite(est.losses_).all()
