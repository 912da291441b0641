"""The port's streamed predict (`bayesnf_torch/inference/predict_stream.py`)
on the CPU.

Held to the port's in-memory predict bit for bit (`torch.equal`), as
`tests/test_predict_stream.py` holds the JAX package's, case for case: the
NORMAL, NB and ZINB models on a ragged tail, any host chunk size, the VI
ensemble axes, `forecast_params_bnf`, the estimator's `predict` and
`likelihood_model`, any `stream_cache_bytes` (accepted and ignored: no
device cache) and a single chunk. Two cases are held to rounding there and
here: the approximate quantiles and the
quantiles over a mesh (rtol 1e-6, atol 1e-7), with the means bit for bit.

Held to `bayesnf_tpu`'s streamed predict on the same numpy parameters and
grid (`test_torch_predict.py`'s bounds): means to rtol 2e-5 / atol 1e-4,
NORMAL quantiles to rtol 2e-5 plus 1e-4 of the largest member noise scale,
count quantiles within one count on at most max(1, 1%) of the rows
(PARITY.md).

Also: the host chunk's rows, the copy pipelines' CUDA branches run on CPU
tensors with streams and events that do nothing (and the fetch event's
stream), and `cli/stream_scale_run.py` at 20,000 rows.
"""

import contextlib
import functools
import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.cli import stream_scale_run
from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import predict as t_predict
from bayesnf_torch.inference import predict_stream as t_stream
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.parallel import mesh as t_mesh
from bayesnf_torch.parallel import streaming as t_streaming
from bayesnf_tpu.inference import predict as j_predict
from bayesnf_tpu.models import field as j_field

torch.set_num_threads(1)

CONFIG = dict(
    width=16, depth=2, input_scales=[30.0, 1.0], fourier_degrees=[2, 2],
    interactions=[(0, 1)], seasonality_periods=[8.0],
    num_seasonal_harmonics=[2])
KWARGS = dict(quantiles=(0.5, 0.975), ensemble_dims=2, chunk_size=16)
MEANS_TOL = dict(rtol=2e-5, atol=1e-4)
APPROX_TOL = dict(rtol=1e-6, atol=1e-7)


def _arrays(n=100, seed=0, ensemble_shape=(2, 3)):
  """(grid (n, 2), numpy parameters): time 0..n-1 and a normal column;
  parameters scaled like an initialized model."""
  rng = np.random.default_rng(seed)
  x = np.stack([np.arange(n, dtype=np.float32),
                rng.normal(size=n).astype(np.float32)], -1)
  specs = t_field.param_specs(t_field.FieldConfig.create(**CONFIG))
  arrays = [
      (np.clip(rng.normal(size=ensemble_shape + s.shape), -2, 2)
       if s.is_matrix
       else rng.normal(scale=0.5, size=ensemble_shape + s.shape)).astype(
           np.float32)
      for s in specs]
  return x, arrays


def _setup(n=100, seed=0, ensemble_shape=(2, 3)):
  config = t_field.FieldConfig.create(**CONFIG)
  x, arrays = _arrays(n, seed, ensemble_shape)
  return config, x, t_field.params_from_numpy(
      config, arrays, len(ensemble_shape), 'cpu')


@functools.lru_cache(maxsize=None)
def _in_memory(observation_model):
  """The in-memory predict of `_setup()`'s grid, under KWARGS."""
  config, x, params = _setup()
  return t_predict.predict_bnf(x, observation_model, params, config, **KWARGS)


def _assert_bitwise(got, want):
  got_means, got_qs = got
  want_means, want_qs = want
  assert torch.equal(got_means, want_means)
  assert len(got_qs) == len(want_qs)
  for g, w in zip(got_qs, want_qs):
    assert torch.equal(g, w)


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_streamed_matches_in_memory_bitwise(observation_model):
  config, x, params = _setup()
  # 32-row host chunks over 100 rows: 4 chunks, a ragged 4-row tail.
  got = t_predict.predict_bnf(x, observation_model, params, config,
                              stream_chunk_rows=32, **KWARGS)
  _assert_bitwise(got, _in_memory(observation_model))
  assert got[0].device == torch.device('cpu')
  assert tuple(got[0].shape) == (2, 3, 100)


def test_stream_chunk_rows_is_bit_invariant():
  config, x, params = _setup()
  runs = [t_predict.predict_bnf(x, 'NORMAL', params, config,
                                stream_chunk_rows=rows, **KWARGS)
          # 25 is not a whole number of 16-row device chunks: rounded up.
          for rows in (16, 64, 25)]
  for run in runs:
    _assert_bitwise(run, _in_memory('NORMAL'))


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_streamed_vi_shape_contract(observation_model):
  # VI's ensemble_dims=3 (groups, samples, members).
  config, x, params = _setup(n=40, ensemble_shape=(1, 2, 2))
  kwargs = dict(KWARGS, quantiles=(0.5,), ensemble_dims=3)
  want = t_predict.predict_bnf(x, observation_model, params, config,
                               **kwargs)
  got = t_predict.predict_bnf(x, observation_model, params, config,
                              stream_chunk_rows=16, **kwargs)
  _assert_bitwise(got, want)
  assert tuple(got[0].shape) == (1, 2, 2, 40)


def test_streamed_approximate_quantiles():
  config, x, params = _setup(n=50)
  kwargs = dict(KWARGS, quantiles=(0.5, 0.9), approximate_quantiles=True)
  want = t_predict.predict_bnf(x, 'NORMAL', params, config, **kwargs)
  got = t_predict.predict_bnf(x, 'NORMAL', params, config,
                              stream_chunk_rows=16, **kwargs)
  # The means stay bit for bit; the moment-matched quantiles are held to
  # rounding, as in the JAX package.
  assert torch.equal(got[0], want[0])
  for g, w in zip(got[1], want[1]):
    torch.testing.assert_close(g, w, **APPROX_TOL)


def test_streamed_over_mesh_matches_in_memory():
  config, x, params = _setup(n=96)
  mesh = t_mesh.default_mesh(['cpu'] * 4, data_devices=2)
  kwargs = dict(KWARGS, chunk_size=32, mesh=mesh)
  want = t_predict.predict_bnf(x, 'NORMAL', params, config, **kwargs)
  got = t_predict.predict_bnf(x, 'NORMAL', params, config,
                              stream_chunk_rows=32, **kwargs)
  # The JAX package's bound over a mesh: means bit for bit, quantiles to
  # rounding.
  assert torch.equal(got[0], want[0])
  for g, w in zip(got[1], want[1]):
    torch.testing.assert_close(g, w, **APPROX_TOL)


@pytest.mark.parametrize('observation_model', ['NORMAL', 'ZINB'])
def test_streamed_forecast_params_bitwise(observation_model):
  config, x, params = _setup(n=70)
  want = t_predict.forecast_params_bnf(
      x, observation_model, params, config, ensemble_dims=2, chunk_size=16)
  for cache_bytes in (1 << 30, 6 * 32 * 4 * 2, 0, None):
    got = t_predict.forecast_params_bnf(
        x, observation_model, params, config, ensemble_dims=2,
        chunk_size=16, stream_chunk_rows=32, stream_cache_bytes=cache_bytes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
      assert g.device == torch.device('cpu') and torch.equal(g, w)


def _table(n, seed, period):
  rng = np.random.default_rng(seed)
  t = np.arange(n, dtype=float) % period
  lat = rng.normal(size=n)
  y = np.sin(2 * np.pi * t / 8) * 4 + lat + 0.1 * rng.normal(size=n)
  return pd.DataFrame({'time': t, 'lat': lat, 'y': y})


def _estimator():
  return bayesnf_torch.BayesianNeuralFieldMAP(
      width=16, depth=1, seasonality_periods=[8.0],
      feature_cols=['time', 'lat'], target_col='y',
      observation_model='NORMAL', timetype='float', standardize=['lat'])


def test_estimator_streamed_predict_and_likelihood_model():
  df = _table(80, 0, 40)
  m = _estimator().fit(df, seed=0, ensemble_size=4, num_epochs=8,
                       batch_size=20, backend='torch', device='cpu',
                       stream_chunk_steps=4)
  want = m.predict(df, quantiles=(0.5, 0.975))
  got = m.predict(df, quantiles=(0.5, 0.975), stream_chunk_rows=32)
  _assert_bitwise(got, want)

  lm_mem = m.likelihood_model(df)
  lm_str = m.likelihood_model(df, stream_chunk_rows=32, stream_cache_bytes=0)
  y = torch.tensor(df.y.values, dtype=torch.float32)
  assert torch.equal(lm_str.mean(), lm_mem.mean())
  assert torch.equal(lm_str.log_prob(y), lm_mem.log_prob(y))


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_cache_budget_bit_invariant(observation_model):
  """`stream_cache_bytes` is accepted for the JAX package's signature and
  ignored: any budget gives the in-memory predict's bits."""
  config, x, params = _setup()
  for cache_bytes in (1 << 30, 6 * 32 * 4, 0):
    got = t_predict.predict_bnf(
        x, observation_model, params, config, stream_chunk_rows=32,
        stream_cache_bytes=cache_bytes, **KWARGS)
    _assert_bitwise(got, _in_memory(observation_model))


def test_estimator_stream_cache_bytes_kwarg():
  df = _table(60, 1, 30)
  m = _estimator().fit(df, seed=0, ensemble_size=4, num_epochs=4,
                       backend='torch', device='cpu')
  want = m.predict(df, quantiles=(0.5,))
  got = m.predict(df, quantiles=(0.5,), stream_chunk_rows=16,
                  stream_cache_bytes=0)
  _assert_bitwise(got, want)
  # A budget without stream_chunk_rows is ignored: the in-memory predict.
  _assert_bitwise(m.predict(df, quantiles=(0.5,), stream_cache_bytes=0),
                  want)


def test_single_chunk_degenerate():
  # stream_chunk_rows >= N: one chunk, still bit-equal.
  config, x, params = _setup(n=30)
  kwargs = dict(KWARGS, quantiles=(0.5,))
  want = t_predict.predict_bnf(x, 'NB', params, config, **kwargs)
  got = t_predict.predict_bnf(x, 'NB', params, config,
                              stream_chunk_rows=10_000, **kwargs)
  _assert_bitwise(got, want)


@pytest.mark.parametrize('stream_chunk_rows,n,want', [
    (25, 100, 32),     # Rounded up to whole 16-row device chunks.
    (64, 100, 64),
    (10_000, 100, 112),  # No more than the table's chunks.
])
def test_resolve_rows(stream_chunk_rows, n, want):
  assert t_stream._resolve_rows(stream_chunk_rows, 16, n) == want  # pylint: disable=protected-access


def test_resolve_rows_refuses_an_empty_table():
  with pytest.raises(ValueError, match='at least one row'):
    t_stream._resolve_rows(16, 16, 0)  # pylint: disable=protected-access


def _jax_streamed(observation_model, x, arrays, quantiles):
  return j_predict.predict_bnf(
      x, observation_model, tuple(jnp.asarray(a) for a in arrays),
      j_field.FieldConfig.create(**CONFIG), quantiles=quantiles,
      ensemble_dims=2, chunk_size=16, backend='xla', stream_chunk_rows=32)


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_streamed_matches_jax_streamed(observation_model):
  # 100 rows: 4 host chunks of 32, the last 4 rows and 28 of padding.
  x, arrays = _arrays()
  want_means, want_qs = _jax_streamed(observation_model, x, arrays,
                                      KWARGS['quantiles'])
  got_means, got_qs = t_predict.predict_bnf(
      x, observation_model, _setup()[2], t_field.FieldConfig.create(**CONFIG),
      stream_chunk_rows=32, **KWARGS)
  np.testing.assert_allclose(got_means.numpy(), np.asarray(want_means),
                             **MEANS_TOL)
  for g, w in zip(got_qs, want_qs):
    g, w = g.numpy(), np.asarray(w)
    if observation_model == 'NORMAL':
      atol = 1e-4 * (0.01 + np.exp(arrays[0].max()))
      np.testing.assert_allclose(g, w, rtol=2e-5, atol=atol)
    else:
      off = np.abs(g - w)
      assert off.max() <= 1.0
      assert (off > 0).sum() <= max(1, g.size // 100)


def test_stream_scale_run_on_the_cpu(tmp_path):
  out = tmp_path / 'scale.json'
  artifact = stream_scale_run.main([
      '--json-out', str(out), '--rows', '20000', '--ensemble', '2',
      '--width', '16', '--device', 'cpu', '--batch-size', '4096',
      '--stream-chunk-rows', '8192', '--workdir', str(tmp_path)])
  assert artifact['fit_losses_bit_invariant_to_slice_size'] is True
  assert artifact['predict_bit_identical_on_4096_sampled_rows'] is True
  assert artifact['streamed_predict']['chunks'] == 3
  assert artifact['device_kind'] == 'cpu'
  assert artifact['streamed_fit']['peak_device_bytes'] is None
  with open(out) as f:
    assert json.load(f) == artifact


class _NoEvent:

  def record(self, *args):
    pass

  def synchronize(self):
    pass


class _NoStream:

  def __init__(self, *args):
    pass

  def wait_event(self, event):
    pass


def _use_cuda_branches(monkeypatch):
  """Runs `HostUploads` and `_Fetches` through their CUDA branches (two
  slots of staging buffers, a copy stream, events) on CPU tensors, with
  streams and events that do nothing and unpinned staging buffers: their
  slot logic, which only the card runs otherwise."""
  monkeypatch.setattr(torch.cuda, 'Event', lambda *a, **k: _NoEvent())
  monkeypatch.setattr(torch.cuda, 'Stream', _NoStream)
  monkeypatch.setattr(torch.cuda, 'current_stream', lambda *a: _NoStream())
  monkeypatch.setattr(torch.cuda, 'stream',
                      lambda stream: contextlib.nullcontext())
  empty = torch.empty
  monkeypatch.setattr(torch, 'empty',
                      lambda *a, pin_memory=False, **k: empty(*a, **k))
  init = t_streaming.HostUploads.__init__

  def cuda_init(self, shapes, device):
    init(self, shapes, device)
    self.cuda = True
    self._slots = [t_streaming._Slot(self.shapes, self.device)  # pylint: disable=protected-access
                   for _ in range(2)]
    self._copies = self._compute = _NoStream()

  monkeypatch.setattr(t_streaming.HostUploads, '__init__', cuda_init)
  fetches_init = t_stream._Fetches.__init__  # pylint: disable=protected-access

  def cuda_fetches_init(self, device):
    fetches_init(self, device)
    self.cuda = True

  monkeypatch.setattr(t_stream._Fetches, '__init__', cuda_fetches_init)  # pylint: disable=protected-access


@pytest.mark.parametrize('observation_model', ['NORMAL', 'ZINB'])
def test_cuda_copy_branches_keep_the_results(observation_model,
                                             monkeypatch):
  config, x, params = _setup()
  want = _in_memory(observation_model)
  _use_cuda_branches(monkeypatch)
  _assert_bitwise(t_predict.predict_bnf(
      x, observation_model, params, config, stream_chunk_rows=32, **KWARGS),
                  want)


def test_fetch_event_waits_on_the_stream_of_the_tensors_device(
    monkeypatch):
  """A device-to-host copy runs on the current stream of its tensor's
  device, which need not be the current device: the event a fetch waits
  for is recorded on that stream."""
  _use_cuda_branches(monkeypatch)
  streams, recorded = {}, []

  class Event(_NoEvent):

    def record(self, *args):
      recorded.append(args)

  monkeypatch.setattr(torch.cuda, 'Event', Event)
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda *a: streams.setdefault(a, _NoStream()))
  stored = []
  fetches = t_stream._Fetches(torch.device('cpu'))  # pylint: disable=protected-access
  for value in range(3):
    fetches.dispatch([torch.full((2, 4), float(value))],
                     lambda arrays: stored.append(arrays[0].tolist()))
  fetches.drain()
  assert stored == [[[float(v)] * 4] * 2 for v in range(3)]
  want = streams[(torch.device('cpu'),)]
  assert len(recorded) == 3
  assert all(args == (want,) for args in recorded)


def test_cuda_copy_branch_of_the_streamed_fit(monkeypatch):
  config = t_field.FieldConfig.create(**CONFIG)
  x, _ = _arrays(n=50)
  y = (np.sin(x[:, 0]) + x[:, 1]).astype(np.float32)
  aug = t_field.aug_features_host(config, x)

  def fit(slice_steps):
    return t_map.ensemble_map(
        aug, y, config, t_likelihoods.LikelihoodDist.NORMAL, 3, 0.01, 3, 0,
        batch_size=10, backend='torch', device='cpu',
        stream_chunk_steps=slice_steps)

  want_params, want_losses = fit(3)
  _use_cuda_branches(monkeypatch)
  for slice_steps in (3, 2):
    params, losses = fit(slice_steps)
    assert np.array_equal(losses, want_losses)
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
