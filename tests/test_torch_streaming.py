"""Host-streaming training in the port (`bayesnf_torch.parallel.streaming`,
`map.stream_train`, `vi.stream_train`, `field.aug_features_host`).

Held to `bayesnf_tpu`:
- Given the JAX package's entropy (`stream_entropy` of the `opt_seed` of
  `map._make_init_fn`), `epoch_permutation`, `step_sample` and
  `HostBatchStream`'s slices (MAP and VI modes) are the JAX package's, bit
  for bit.
- `aug_features_host` against the JAX package's, into a new array and into
  an `np.memmap`, to rtol 1e-6 / atol 1e-6.
- A streamed MAP or MLE train from the JAX package's initial parameters and
  entropy against its `ensemble_map(stream_chunk_steps=2, backend='xla')`:
  per-epoch losses to rtol 1e-5, final parameters to 1e-4 of each leaf's
  largest magnitude (`test_torch_map.py`'s minibatch bounds), on 'torch'
  and on the 'kernel' path (plain K1 on CPU tensors).

The port's invariants (`tests/test_streaming.py`'s): results bit for bit
the same for any slice size (MAP, VI), resumed bit for bit, two data shards
within rtol 1e-6 of one, remix differing from the shared stream,
deterministic and resumable, the remix alignment errors, the streamed VI
equal to `make_step` on the stream's batches with the same noise, the
argument checks, and the estimator on a memmap table.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import vi as t_vi
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.parallel import mesh as t_mesh
from bayesnf_torch.parallel import streaming as t_streaming
from bayesnf_tpu.inference import map as j_map
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import likelihoods as j_likelihoods
from bayesnf_tpu.parallel import mesh as j_mesh
from bayesnf_tpu.parallel import streaming as j_streaming

torch.set_num_threads(1)

NORMAL_T = t_likelihoods.LikelihoodDist.NORMAL
CONFIG_KWARGS = dict(
    width=8, depth=1, input_scales=[30.0, 1.0], fourier_degrees=[2, 2],
    interactions=[], seasonality_periods=[8.0], num_seasonal_harmonics=[2])
MEMBERS = 3
LR = 0.01
BATCH = 10
TRAJ_LOSS_RTOL = 1e-5
TRAJ_PARAM_TOL = 1e-4


def _raw(n=50):
  rng = np.random.default_rng(1)
  x = np.stack([np.arange(n, dtype=np.float32),
                rng.normal(size=n).astype(np.float32)], -1)
  y = (x[:, 1] + np.sin(x[:, 0] / 5)).astype(np.float32)
  return x, y


def _setup(n=50):
  config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  x, y = _raw(n)
  return config, t_field.aug_features_host(config, x), y


def _jax_entropy_and_init(j_config, y, members=MEMBERS):
  """The JAX package's initial ensemble (numpy) and its host entropy."""
  mesh = j_mesh.default_mesh(jax.devices()[:1])
  init = j_map._make_init_fn  # pylint: disable=protected-access
  params, _, _, opt_seed = init(j_config, LR, members, mesh)(
      jax.random.PRNGKey(0), np.float32(np.log(np.nanstd(y) / 2.0)))
  return mesh, [np.array(p) for p in params], j_streaming.stream_entropy(
      opt_seed)


def _map(config, aug, y, **kwargs):
  kwargs.setdefault('num_epochs', 4)
  params, losses = t_map.ensemble_map(
      aug, y, config, NORMAL_T, ensemble_size=MEMBERS, learning_rate=LR,
      seed=0, batch_size=BATCH, backend='torch', device='cpu', **kwargs)
  return list(params), losses


def _vi(config, aug, y, **kwargs):
  kwargs.setdefault('num_epochs', 6)
  surrogate, losses, draws = t_vi.fit_vi(
      aug[:40], y[:40], 0, 'NORMAL', config, ensemble_size=MEMBERS,
      learning_rate=LR, sample_size_divergence=2, sample_size_posterior=2,
      batch_size=BATCH, backend='torch', device='cpu', **kwargs)
  return [*surrogate[0], *surrogate[1], *draws], losses


FITS = {'map': _map, 'vi': _vi}


def _assert_same(got, want):
  np.testing.assert_array_equal(got[1], want[1])
  for a, b in zip(got[0], want[0]):
    assert torch.equal(a, b)


def _leaf_close(got, want, tol, what):
  for i, (g, w) in enumerate(zip(got, want)):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (what, i)
    bound = tol * max(np.abs(w).max(), np.finfo(np.float32).tiny)
    assert np.abs(g - w).max() <= bound, (what, i, np.abs(g - w).max(), bound)


# -- The batch schedule and the rows, against the JAX package ---------------


@pytest.mark.parametrize('per_step_resample', [False, True],
                         ids=['map', 'vi'])
def test_schedule_is_the_jax_packages_bit_for_bit(per_step_resample):
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  x, y = _raw(23)
  aug = np.asarray(j_field.aug_features_host(j_config, x))
  _, _, entropy = _jax_entropy_and_init(j_config, y)
  for epoch in (0, 1, 5):
    np.testing.assert_array_equal(
        t_streaming.epoch_permutation(entropy, epoch, 23),
        j_streaming.epoch_permutation(entropy, epoch, 23))
    np.testing.assert_array_equal(
        t_streaming.step_sample(entropy, epoch, 23, 5),
        j_streaming.step_sample(entropy, epoch, 23, 5))
  got = t_streaming.HostBatchStream(aug.T, y, 5, entropy, per_step_resample)
  want = j_streaming.HostBatchStream(aug.T, y, 5, jax.random.PRNGKey(0),
                                     per_step_resample)
  want._entropy = entropy  # pylint: disable=protected-access
  for step in (7, 0, 5, 3):  # any order: resume replays any step
    np.testing.assert_array_equal(
        got.batch_rows(step),
        want._batch_rows(step))  # pylint: disable=protected-access
  for (s_g, a_g, y_g), (s_w, a_w, y_w) in zip(got.slices(2, 9, 4),
                                              want.slices(2, 9, 4)):
    assert s_g == s_w
    np.testing.assert_array_equal(a_g, a_w)
    np.testing.assert_array_equal(y_g, y_w)
  out = (np.zeros((4, aug.shape[1], 5), np.float32),
         np.zeros((4, 5), np.float32))
  a_o, y_o = got.slice_at(6, 3, out=out)
  a_w, y_w = want.slice_at(6, 3)
  np.testing.assert_array_equal(a_o, a_w)
  np.testing.assert_array_equal(out[1][:3], y_w)
  assert not out[0][3].any()


def test_aug_features_host_matches_jax(tmp_path):
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  t_config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  x, _ = _raw(70)
  want = np.asarray(j_field.aug_features_host(j_config, x))
  got = t_field.aug_features_host(t_config, x, block_rows=16)
  assert got.dtype == np.float32 and got.shape == want.shape == (70, 6)
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
  mm = np.memmap(str(tmp_path / 'aug.f32'), dtype=np.float32, mode='w+',
                 shape=want.shape)
  assert t_field.aug_features_host(t_config, x, out=mm) is mm
  np.testing.assert_array_equal(np.asarray(mm), got)
  for bad in (np.empty((70, 7), np.float32), np.empty((70, 6), np.float64)):
    with pytest.raises(ValueError, match='out must be float32'):
      t_field.aug_features_host(t_config, x, out=bad)


@pytest.mark.parametrize('prior_weight', [1.0, 0.0], ids=['MAP', 'MLE'])
@pytest.mark.parametrize('backend', ['torch', 'kernel'],
                         ids=['torch', 'kernel-path'])
def test_stream_train_matches_jax_streamed_ensemble_map(prior_weight,
                                                        backend):
  j_config = j_field.FieldConfig.create(**CONFIG_KWARGS)
  t_config = t_field.FieldConfig.create(**CONFIG_KWARGS)
  x, y = _raw()
  aug = np.asarray(j_field.aug_features_host(j_config, x))
  mesh, params0, entropy = _jax_entropy_and_init(j_config, y)
  epochs = 4  # 5 steps an epoch, in slices of 2
  want_params, want_losses = j_map.ensemble_map(
      aug, y, j_config, j_likelihoods.LikelihoodDist.NORMAL, MEMBERS, LR,
      epochs, jax.random.PRNGKey(0), batch_size=BATCH,
      prior_weight=prior_weight, mesh=mesh, backend='xla',
      stream_chunk_steps=2)
  t_params = tuple(torch.as_tensor(p) for p in params0)
  stream = t_streaming.HostBatchStream(aug.T, y, BATCH, entropy)
  got_params, state, got_losses = t_map.stream_train(
      t_params, t_map.init_opt_state(t_params), stream, t_config, NORMAL_T,
      LR, epochs, prior_weight=prior_weight, backend=backend, slice_steps=2)
  assert state.count == 5 * epochs
  assert got_losses.shape == (MEMBERS, epochs)
  np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                             rtol=TRAJ_LOSS_RTOL)
  _leaf_close([p.numpy() for p in got_params], want_params, TRAJ_PARAM_TOL,
              'params')


# -- The port's invariants ---------------------------------------------------


@pytest.mark.parametrize('fit', FITS)
def test_slice_size_is_bit_invariant(fit):
  config, aug, y = _setup()
  _assert_same(FITS[fit](config, aug, y, stream_chunk_steps=3),
               FITS[fit](config, aug, y, stream_chunk_steps=20))
  _assert_same(FITS[fit](config, aug, y, stream_chunk_steps=1),
               FITS[fit](config, aug, y, stream_chunk_steps=2))


@pytest.mark.parametrize('fit', FITS)
def test_streamed_checkpoint_resume_is_bit_exact(fit, tmp_path):
  config, aug, y = _setup()
  want = FITS[fit](config, aug, y, stream_chunk_steps=3)
  ckdir = str(tmp_path / 'ck')
  # Interrupted after 2 of 4 epochs (VI: 4 of 6 steps), saved every 2.
  FITS[fit](config, aug, y, num_epochs=2 if fit == 'map' else 4,
            stream_chunk_steps=3, checkpoint_dir=ckdir, checkpoint_every=2)
  _assert_same(FITS[fit](config, aug, y, stream_chunk_steps=3,
                         checkpoint_dir=ckdir, checkpoint_every=2), want)


@pytest.mark.parametrize('fit', FITS)
def test_streaming_checkpoint_refuses_on_device_resume(fit, tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  FITS[fit](config, aug, y, stream_chunk_steps=3, checkpoint_dir=ckdir)
  with pytest.raises(ValueError, match='different configuration'):
    FITS[fit](config, aug, y, checkpoint_dir=ckdir)
  # Nor does a remix resume a shared stream.
  with pytest.raises(ValueError, match='different configuration'):
    FITS[fit](config, aug, y, stream_chunk_steps=3, stream_member_remix=True,
              checkpoint_dir=ckdir)


@pytest.mark.parametrize('fit', FITS)
def test_two_data_shards_only_reassociate(fit):
  config, aug, y = _setup()
  mesh = t_mesh.default_mesh(['cpu'] * 2, data_devices=2)
  for remix in (False, True):
    one = FITS[fit](config, aug, y, stream_chunk_steps=3,
                    stream_member_remix=remix)
    two = FITS[fit](config, aug, y, stream_chunk_steps=3, mesh=mesh,
                    stream_member_remix=remix)
    if remix:  # each shard remixes its own half of the slice
      assert not np.array_equal(one[1], two[1])
      continue
    np.testing.assert_allclose(two[1], one[1], rtol=1e-6)
    for a, b in zip(two[0], one[0]):
      np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('fit', FITS)
def test_member_remix_differs_is_deterministic_and_resumes(fit, tmp_path):
  config, aug, y = _setup()
  kwargs = dict(stream_chunk_steps=5 if fit == 'map' else 2,
                stream_member_remix=True)
  shared = FITS[fit](config, aug, y, stream_chunk_steps=kwargs[
      'stream_chunk_steps'])
  want = FITS[fit](config, aug, y, **kwargs)
  assert np.isfinite(want[1]).all()
  assert not np.array_equal(want[1], shared[1])
  _assert_same(FITS[fit](config, aug, y, **kwargs), want)
  # Checkpoint chunks of 10 MAP steps (2 epochs) or 2 VI steps: whole
  # windows.
  ckdir = str(tmp_path / 'ck')
  FITS[fit](config, aug, y, num_epochs=2 if fit == 'map' else 4,
            checkpoint_dir=ckdir, checkpoint_every=2, **kwargs)
  _assert_same(FITS[fit](config, aug, y, checkpoint_dir=ckdir,
                         checkpoint_every=2, **kwargs), want)


def test_remix_depends_on_the_seed_not_the_grouping():
  config, aug, y = _setup()
  kwargs = dict(stream_chunk_steps=5, stream_member_remix=True)
  one = _map(config, aug, y, **kwargs)
  other_seed = t_map.ensemble_map(
      aug, y, config, NORMAL_T, ensemble_size=MEMBERS, learning_rate=LR,
      num_epochs=4, seed=1, batch_size=BATCH, backend='torch', device='cpu',
      **kwargs)
  assert not np.array_equal(one[1], other_seed[1])
  # Three 'ens' groups of one member: each member the same batches.
  mesh = t_mesh.default_mesh(['cpu'] * 3, ensemble_devices=3)
  grouped = _map(config, aug, y, mesh=mesh, **kwargs)
  np.testing.assert_allclose(grouped[1], one[1], rtol=1e-6)
  idx = t_streaming.remix_indices([11, 12], 2, 3, 'cpu')
  assert idx.shape == (2, 2, 3)
  for m in range(2):
    assert sorted(idx[:, m].reshape(-1).tolist()) == list(range(6))
  assert torch.equal(idx, t_streaming.remix_indices([11, 12], 2, 3, 'cpu'))


def test_remix_misalignment_raises(tmp_path):
  config, aug, y = _setup()
  # Checkpoint chunks of 5 steps (1 epoch) are not whole windows of 3.
  with pytest.raises(ValueError, match='remix window'):
    _map(config, aug, y, stream_chunk_steps=3, stream_member_remix=True,
         checkpoint_dir=str(tmp_path / 'a'), checkpoint_every=1)
  # A finished 1-epoch fit ends at step 5, inside a window of 4 steps (the
  # chunk of 4 epochs = 20 steps is whole windows): extending it raises.
  base = dict(stream_chunk_steps=4, stream_member_remix=True,
              checkpoint_dir=str(tmp_path / 'b'), checkpoint_every=4)
  _map(config, aug, y, num_epochs=1, **base)
  with pytest.raises(ValueError, match='window boundary'):
    _map(config, aug, y, num_epochs=2, **base)
  t_streaming.validate_remix_alignment(4, 0, None)
  t_streaming.validate_remix_alignment(4, 8, 8)
  with pytest.raises(ValueError, match='remix window'):
    t_streaming.validate_remix_alignment(4, 0, 6)
  with pytest.raises(ValueError, match='window boundary'):
    t_streaming.validate_remix_alignment(4, 6, 8)


def test_streamed_vi_is_make_step_on_the_streams_batches():
  config, aug, y = _setup(n=40)
  stream = t_streaming.HostBatchStream(aug.T, y, BATCH, (5,),
                                       per_step_resample=True)
  surrogate = t_vi.init_surrogate(config, MEMBERS, 0, 'cpu')
  opt_state = t_map.init_opt_state((*surrogate[0], *surrogate[1]))
  steps, samples, kl_weight = 7, 2, 0.5
  got_surrogate, got_state, got_losses = t_vi.stream_train(
      surrogate, opt_state, stream, config, NORMAL_T, LR, steps, samples,
      kl_weight, torch.Generator().manual_seed(7), 'torch', slice_steps=3)
  step = t_vi.make_step(config, NORMAL_T, (40 / BATCH) / kl_weight, LR,
                        'torch')
  generator = torch.Generator().manual_seed(7)
  d = config.num_inputs
  losses = []
  for t in range(steps):
    noise = t_vi.draw_noise(config, MEMBERS, samples, generator)
    rows = stream.batch_rows(t)
    batch = torch.as_tensor(aug[rows].T.copy())
    surrogate, opt_state, step_losses = step(
        surrogate, opt_state, noise, batch[:d], batch[d:],
        torch.as_tensor(y[rows]))
    losses.append(step_losses)
  assert got_state.count == opt_state.count == steps
  assert torch.equal(got_losses, torch.stack(losses, dim=1) * kl_weight)
  for a, b in zip((*got_surrogate[0], *got_surrogate[1]),
                  (*surrogate[0], *surrogate[1])):
    assert torch.equal(a, b)


@pytest.mark.parametrize('change,match', [
    (dict(batch_size=None, stream_chunk_steps=3), 'minibatch'),
    (dict(stream_chunk_steps=0), 'positive'),
    (dict(stream_member_remix=True), 'host-streaming'),
    (dict(batch_size=7, stream_chunk_steps=3,
          mesh=t_mesh.default_mesh(['cpu'] * 2, data_devices=2)),
     'data_shards'),
], ids=['full-batch', 'zero-steps', 'remix-alone', 'uneven-shards'])
@pytest.mark.parametrize('fit', ['map', 'vi'])
def test_stream_argument_checks(fit, change, match):
  config, aug, y = _setup()
  kwargs = dict(num_epochs=1, ensemble_size=MEMBERS, learning_rate=LR,
                backend='torch', device='cpu', batch_size=BATCH)
  kwargs.update(change)
  with pytest.raises(ValueError, match=match):
    if fit == 'map':
      t_map.ensemble_map(aug, y, config, NORMAL_T, seed=0, **kwargs)
    else:
      t_vi.fit_vi(aug, y, 0, 'NORMAL', config, **kwargs)


def test_memmap_table_matches_ram_bit_for_bit(tmp_path):
  config, aug, y = _setup()
  x, _ = _raw()
  mm = np.memmap(str(tmp_path / 'aug.f32'), dtype=np.float32, mode='w+',
                 shape=aug.shape)
  t_field.aug_features_host(config, x, out=mm)
  for fit in FITS.values():
    _assert_same(fit(config, mm, y, stream_chunk_steps=3),
                 fit(config, aug, y, stream_chunk_steps=3))


@pytest.mark.parametrize('cls', ['BayesianNeuralFieldMAP',
                                 'BayesianNeuralFieldVI'])
def test_estimator_streamed_fit_and_predict(cls, monkeypatch):
  n = 60
  rng = np.random.default_rng(0)
  t = np.arange(n, dtype=float) % 40
  lat = rng.normal(size=n)
  y = np.sin(2 * np.pi * t / 8) * 4 + lat + 0.1 * rng.normal(size=n)
  df = pd.DataFrame({'time': t, 'lat': lat, 'y': y})
  seen = []
  real = t_field.aug_features_host

  def spy(*args, **kwargs):
    seen.append(True)
    return real(*args, **kwargs)

  monkeypatch.setattr(t_field, 'aug_features_host', spy)
  est = getattr(bayesnf_torch, cls)(
      width=8, depth=1, seasonality_periods=[8.0],
      feature_cols=['time', 'lat'], target_col='y',
      observation_model='NORMAL', timetype='float', standardize=['lat'])
  kwargs = dict(sample_size_divergence=2, sample_size_posterior=3) if (
      cls == 'BayesianNeuralFieldVI') else {}
  est.fit(df, seed=0, ensemble_size=2, num_epochs=6, learning_rate=0.02,
          batch_size=15, backend='torch', device='cpu',
          stream_chunk_steps=3, **kwargs)
  assert seen == [True]  # the rows were built on the host
  steps = 6 * (60 // 15) if kwargs else 6
  assert est.losses_.shape == (1, 2, steps)
  assert np.isfinite(est.losses_).all()
  means, quantiles = est.predict(df, quantiles=(0.5,))
  assert bool(torch.isfinite(means).all())
  assert bool(torch.isfinite(quantiles[0]).all())
