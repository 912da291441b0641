"""Checkpoint and resume of the port's fits (`bayesnf_torch.utils.checkpoint`,
`map.ensemble_map`, `vi.fit_vi`), the invariants of `tests/test_checkpoint.py`.

- A fit in checkpointed chunks equals the fit in one run, bit for bit, and
  so does a fit interrupted and resumed from its directory: MAP full batch,
  MAP and MLE minibatch (whose permutation generators are restored), VI
  (surrogate, losses and posterior draws; its step generator restored).
- A finished fit run again is a no-op; another configuration, another
  resolved backend or a remote URI is refused; a marker without saves is
  reclaimed, and the fit that lost it cannot save; a digest of the
  superseded recipe resumes; a torn marker reads as absent.
- The fingerprint is the JAX package's recipe, digit for digit.
"""

import json
import os

import numpy as np
import pytest
import torch

from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import vi as t_vi
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.utils import checkpoint as t_ckpt
from bayesnf_tpu.utils import checkpoint as j_ckpt

torch.set_num_threads(1)

NORMAL = t_likelihoods.LikelihoodDist.NORMAL


def _setup(n=60):
  config = t_field.FieldConfig.create(
      width=8, depth=1, input_scales=[30.0, 1.0], fourier_degrees=[2, 2],
      interactions=[], seasonality_periods=[], num_seasonal_harmonics=[])
  rng = np.random.default_rng(1)
  x = np.stack([np.arange(n, dtype=np.float32),
                rng.normal(size=n).astype(np.float32)], -1)
  y = (x[:, 1] + np.sin(x[:, 0] / 5)).astype(np.float32)
  return config, t_field.aug_features_host(config, x), y


def _map(config, aug, y, num_epochs=20, batch_size=20, prior_weight=1.0,
         **kwargs):
  params, losses = t_map.ensemble_map(
      aug, y, config, NORMAL, ensemble_size=2, learning_rate=0.01,
      num_epochs=num_epochs, seed=0, batch_size=batch_size,
      prior_weight=prior_weight, backend='torch', device='cpu', **kwargs)
  return list(params), losses


def _vi(config, aug, y, num_epochs=20, batch_size=20, **kwargs):
  surrogate, losses, draws = t_vi.fit_vi(
      aug, y, 0, 'NORMAL', config, ensemble_size=2, learning_rate=0.02,
      num_epochs=num_epochs, sample_size_divergence=2,
      sample_size_posterior=3, batch_size=batch_size, backend='torch',
      device='cpu', **kwargs)
  return [*surrogate[0], *surrogate[1], *draws], losses


FITS = {
    'map-full': lambda *a, **k: _map(*a, batch_size=None, **k),
    'map-minibatch': _map,
    'mle-minibatch': lambda *a, **k: _map(*a, prior_weight=0.0, **k),
    'vi-minibatch': _vi,
}


def _assert_same(got, want):
  (got_leaves, got_losses), (want_leaves, want_losses) = got, want
  np.testing.assert_array_equal(got_losses, want_losses)
  assert len(got_leaves) == len(want_leaves)
  for a, b in zip(got_leaves, want_leaves):
    assert a.dtype == b.dtype and a.is_contiguous() == b.is_contiguous()
    assert torch.equal(a, b)


@pytest.mark.parametrize('fit', FITS, ids=list(FITS))
def test_chunked_checkpointed_fit_matches_single_run(fit, tmp_path):
  config, aug, y = _setup()
  _assert_same(FITS[fit](config, aug, y, checkpoint_dir=str(tmp_path / 'ck'),
                         checkpoint_every=7),
               FITS[fit](config, aug, y))


@pytest.mark.parametrize('fit', FITS, ids=list(FITS))
def test_resume_from_checkpoint_is_bit_exact(fit, tmp_path):
  config, aug, y = _setup()
  want = FITS[fit](config, aug, y)
  # An interrupted fit: 14 of 20 epochs (VI: steps), saved every 7.
  ckdir = str(tmp_path / 'ck')
  FITS[fit](config, aug, y, num_epochs=14, checkpoint_dir=ckdir,
            checkpoint_every=7)
  assert t_ckpt.TrainCheckpointer(ckdir).steps() == [7, 14]
  _assert_same(FITS[fit](config, aug, y, checkpoint_dir=ckdir,
                         checkpoint_every=7), want)
  # Two saves kept: 14 and the final 20 (7 and 14 before the resume).
  assert t_ckpt.TrainCheckpointer(ckdir).steps() == [14, 20]


@pytest.mark.parametrize('fit', ['map-minibatch', 'vi-minibatch'])
def test_completed_fit_run_again_is_a_noop(fit, tmp_path, monkeypatch):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  first = FITS[fit](config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)

  def no_training(*args, **kwargs):
    raise AssertionError('a finished fit trained again')

  monkeypatch.setattr(t_map, 'train', no_training)
  monkeypatch.setattr(t_vi, 'train', no_training)
  _assert_same(FITS[fit](config, aug, y, checkpoint_dir=ckdir,
                         checkpoint_every=7), first)


def test_mismatched_config_checkpoint_raises(tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  _map(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  # Same shapes, another learning rate: without the fingerprint it would
  # resume the wrong fit.
  with pytest.raises(ValueError, match='different configuration'):
    t_map.ensemble_map(
        aug, y, config, NORMAL, ensemble_size=2, learning_rate=0.02,
        num_epochs=20, seed=0, batch_size=20, backend='torch', device='cpu',
        checkpoint_dir=ckdir, checkpoint_every=7)
  # A chunk of no epochs would never end.
  for fit in (_map, _vi):
    with pytest.raises(ValueError, match='checkpoint_every'):
      fit(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=0)


def test_stale_marker_is_reclaimed_and_the_loser_cannot_save(tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  # A fit that stopped before its first save left only its marker.
  t_ckpt.TrainCheckpointer(ckdir, fingerprint='dead-run')
  _, losses = _map(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  assert np.isfinite(losses).all()
  with pytest.raises(ValueError, match='different configuration'):
    t_ckpt.TrainCheckpointer(ckdir, fingerprint='dead-run')
  # Run b reclaims a directory with no save from run a: a's save refuses.
  other = str(tmp_path / 'other')
  a = t_ckpt.TrainCheckpointer(other, fingerprint='run-a')
  b = t_ckpt.TrainCheckpointer(other, fingerprint='run-b')
  state = t_ckpt.TrainState(
      params=(torch.zeros((1, 2)),), opt_count=1, opt_mu=(torch.zeros(1),),
      opt_nu=(torch.zeros(1),), rng_states=(), losses=[torch.zeros((1, 1))],
      epoch=1)
  with pytest.raises(ValueError, match='claimed by a different run'):
    a.save(state)
  b.save(state)
  assert b.restore_latest().epoch == 1


def test_legacy_fingerprint_still_resumes(tmp_path, monkeypatch):
  config, aug, y = _setup()
  want = _map(config, aug, y)
  captured = {}
  real = t_ckpt.TrainCheckpointer

  class Capturing(real):

    def __init__(self, directory, **kwargs):
      captured['legacy'] = kwargs.get('legacy_fingerprints', ())
      super().__init__(directory, **kwargs)

  ckdir = str(tmp_path / 'ck')
  monkeypatch.setattr(t_ckpt, 'TrainCheckpointer', Capturing)
  _map(config, aug, y, num_epochs=14, checkpoint_dir=ckdir,
       checkpoint_every=7)
  monkeypatch.setattr(t_ckpt, 'TrainCheckpointer', real)
  assert len(captured['legacy']) == 1  # no remix: one legacy digest
  marker = os.path.join(ckdir, 'fingerprint.json')
  with open(marker, 'w') as f:
    json.dump({'fingerprint': captured['legacy'][0]}, f)
  _assert_same(_map(config, aug, y, checkpoint_dir=ckdir,
                    checkpoint_every=7), want)
  with open(marker) as f:  # the legacy marker is kept
    assert json.load(f)['fingerprint'] == captured['legacy'][0]
  with open(marker, 'w') as f:
    json.dump({'fingerprint': 'someone-else'}, f)
  with pytest.raises(ValueError, match='different configuration'):
    _map(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)


def test_torn_marker_reads_as_absent(tmp_path):
  c = t_ckpt.TrainCheckpointer(str(tmp_path), fingerprint='abc')
  assert c._read_marker() == 'abc'  # pylint: disable=protected-access
  marker = tmp_path / 'fingerprint.json'
  marker.write_text('{"fingerpr')
  assert c._read_marker() is None  # pylint: disable=protected-access
  marker.write_text('')
  assert c._read_marker() is None  # pylint: disable=protected-access
  # A torn marker does not block the directory, and leaves no debris.
  t_ckpt.TrainCheckpointer(str(tmp_path), fingerprint='xyz')
  assert json.loads(marker.read_text()) == {'fingerprint': 'xyz'}
  assert [p for p in tmp_path.iterdir() if 'tmp' in p.name] == []
  assert t_ckpt.TrainCheckpointer(str(tmp_path / 'new')).restore_latest() is (
      None)


def test_backend_switch_refuses_resume(tmp_path, monkeypatch):
  """'torch' and 'kernel' differ by reassociation: the fingerprint holds the
  resolved backend, so a resume on the other one is refused (before any
  step: here 'kernel' stands for what 'auto' resolves to on a card)."""
  config, aug, y = _setup()
  map_dir, vi_dir = str(tmp_path / 'map'), str(tmp_path / 'vi')
  _map(config, aug, y, checkpoint_dir=map_dir, checkpoint_every=7)
  _vi(config, aug, y, checkpoint_dir=vi_dir, checkpoint_every=7)
  monkeypatch.setattr(t_map, 'resolve_fit_backend',
                      lambda *args: 'kernel')
  with pytest.raises(ValueError, match='different configuration'):
    _map(config, aug, y, checkpoint_dir=map_dir, checkpoint_every=7)
  with pytest.raises(ValueError, match='different configuration'):
    _vi(config, aug, y, checkpoint_dir=vi_dir, checkpoint_every=7)


def test_vi_checkpoint_refuses_a_map_resume(tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  _vi(config, aug, y, checkpoint_dir=ckdir)
  with pytest.raises(ValueError, match='different configuration'):
    _map(config, aug, y, checkpoint_dir=ckdir)


@pytest.mark.parametrize('uri', ['gs://bucket/ckpt', 's3://b/x'])
def test_remote_uri_raises(uri):
  with pytest.raises(ValueError, match='local directories only'):
    t_ckpt.TrainCheckpointer(uri, fingerprint='abc')
  config, aug, y = _setup()
  with pytest.raises(ValueError, match='remote URI'):
    _map(config, aug, y, checkpoint_dir=uri)


def test_fingerprint_is_the_jax_recipe():
  fields = dict(kind='map', ensemble_size=3, learning_rate=0.01,
                batch_size=None, backend='torch', stream=False)
  assert t_ckpt.run_fingerprint(**fields) == j_ckpt.run_fingerprint(**fields)
  config, _, _ = _setup()
  assert repr(config) == repr(_setup()[0])  # no object addresses
  assert 'object at' not in repr(config)


def test_fit_map_checkpoints_each_split(tmp_path):
  config, aug, y = _setup()
  kwargs = dict(seed=0, observation_model='NORMAL', config=config,
                num_particles=4, learning_rate=0.01, num_epochs=6,
                batch_size=20, num_splits=2, backend='torch', device='cpu')
  want = t_map.fit_map(aug, y, **kwargs)
  ckdir = str(tmp_path / 'ck')
  got = t_map.fit_map(aug, y, checkpoint_dir=ckdir, checkpoint_every=2,
                      **kwargs)
  assert sorted(os.listdir(ckdir)) == ['split_0', 'split_1']
  for split in ('split_0', 'split_1'):
    assert t_ckpt.TrainCheckpointer(
        os.path.join(ckdir, split)).steps() == [4, 6]
  _assert_same((list(got[0]), got[1]), (list(want[0]), want[1]))


def test_restore_places_the_saved_tensors(tmp_path):
  c = t_ckpt.TrainCheckpointer(str(tmp_path), max_to_keep=2)
  gen = torch.Generator().manual_seed(3)
  params = (torch.arange(6.0).reshape(2, 3), torch.ones((2, 1)))
  state = t_map.AdamState(5, tuple(p * 2 for p in params),
                          tuple(p * 3 for p in params))
  for epoch in (1, 2, 3):
    c.save(t_ckpt.TrainState.from_fit(params, state, [gen],
                                      [torch.zeros((2, epoch))], epoch))
  assert c.steps() == [2, 3]
  want = torch.rand(4, generator=gen)  # the draw after the saved state
  restored = c.restore_latest()
  placed, (count, mu, nu) = restored.place('cpu')
  assert count == 5 and isinstance(count, int) and restored.epoch == 3
  for a, b in zip((*placed, *mu, *nu), (*params, *state.mu, *state.nu)):
    assert torch.equal(a, b) and a.is_contiguous()
  other = torch.Generator().manual_seed(99)
  restored.restore_generators([other])
  assert torch.equal(torch.rand(4, generator=other), want)
  with pytest.raises(ValueError, match='generator states'):
    restored.restore_generators([])
