"""Meshes across processes (`bayesnf_torch.parallel.distributed`).

The gang tests launch two (or four) Python processes that join a Gloo group
over tcp://localhost, one CPU thread each, and run a scenario of
`_torch_distributed_worker.py` over meshes whose cells are dealt to the
ranks. This process runs the same scenario over the single-process mesh of
each layout. Checked:

- every rank returns the same arrays (params_/losses_ come back whole on
  every rank), and those arrays equal the single-process mesh's with
  `np.array_equal`: MAP and VI over ens 2 x data 1 and 1 x 2 on 75 rows
  (38 / 37: `n_valid` masks a tail), a minibatch over two data shards,
  the predict and `forecast_params_bnf` over 1 x 2;
- the two-rank predict against the JAX package's `predict_bnf` on the same
  parameters, at chip_smoke.py's bounds (means 2e-5 / 1e-4, quantiles 2e-5
  and 1e-4 of the largest noise scale);
- marked slow, as the JAX package's gang tests are
  (`tests/test_multiprocess.py`): streamed fits and the streamed predict
  across ranks, a checkpoint written by rank 0 and resumed by every rank,
  and a four-rank 2 x 2 grid.

A failure to form the group on a loaded host relaunches the gang on a fresh
port (the retry policy of `tests/test_multiprocess.py`); a failure after the
worker's sentinel is never retried.
"""

import importlib.util
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.models import field as t_field
from bayesnf_torch.parallel import distributed
from bayesnf_torch.parallel import mesh as t_mesh
from bayesnf_tpu.inference import predict as j_predict
from bayesnf_tpu.models import field as j_field

_WORKER_PATH = os.path.join(os.path.dirname(__file__),
                            '_torch_distributed_worker.py')
_spec = importlib.util.spec_from_file_location('_torch_distributed_worker',
                                               _WORKER_PATH)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

MEANS_TOL = dict(rtol=2e-5, atol=1e-4)

# Signatures of a group that failed to form (tests/test_multiprocess.py's
# two classes). A communicator that failed to connect is retried whenever
# it happens: Gloo connects each new group (the mesh's row groups) on its
# own, after the sentinel too, and product logic cannot corrupt that
# handshake. The broad spellings (a refused or reset connection, a
# timeout) are retried only for a rank that died before the sentinel;
# after it they mean a dead peer or a deadlock.
_CONTEXT_FORMATION_ERRORS = ('connectFullMesh', 'Gloo connect')
_RENDEZVOUS_ERRORS = _CONTEXT_FORMATION_ERRORS + (
    'Address already in use', 'EADDRINUSE', 'DistNetworkError',
    'DistStoreError', 'Connection refused', 'Connection reset',
    'timed out', 'Timed out')
_ATTEMPTS = 3


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _launch_gang(world, scenario, out_dir, deadline_s):
  """Runs `world` ranks of `scenario`; [(rc, output)] a rank. A rank that
  fails takes the others down at once, and so does the deadline."""
  port = _free_port()
  env = dict(os.environ, OMP_NUM_THREADS='1')
  logs = [open(os.path.join(out_dir, f'rank{r}.log'), 'w+')
          for r in range(world)]
  procs = [subprocess.Popen(
      [sys.executable, _WORKER_PATH, str(r), str(world), str(port),
       scenario, out_dir], stdout=log, stderr=subprocess.STDOUT, env=env)
           for r, log in enumerate(logs)]
  deadline = time.monotonic() + deadline_s
  try:
    while any(p.poll() is None for p in procs):
      failed = any(p.returncode not in (None, 0) for p in procs)
      if failed or time.monotonic() > deadline:
        break
      time.sleep(0.2)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
      p.wait(timeout=30)
  outs = []
  for p, log in zip(procs, logs):
    log.seek(0)
    outs.append((p.returncode, log.read()))
    log.close()
  return outs


def _run_gang(world, scenario, out_dir, deadline_s=600):
  """Every rank's arrays of `scenario`, a list of dicts in rank order."""
  last = None
  for _ in range(_ATTEMPTS):
    outs = _launch_gang(world, scenario, out_dir, deadline_s)
    failures = [(rc, out) for rc, out in outs if rc != 0]
    if not failures:
      results = []
      for r in range(world):
        with np.load(os.path.join(out_dir, f'rank{r}.npz')) as data:
          results.append({k: data[k] for k in data.files})
      return results
    last = '\n'.join(f'rank rc={rc}:\n{out[-4000:]}' for rc, out in outs)
    context = any(sig in out for _, out in failures
                  for sig in _CONTEXT_FORMATION_ERRORS)
    early = any(worker.INIT_SENTINEL not in out and any(
        sig in out for sig in _RENDEZVOUS_ERRORS) for _, out in failures)
    if not (context or early):
      break
  raise AssertionError(f'the gang failed:\n{last}')


def _single_process(scenario, work_dir):
  os.makedirs(work_dir, exist_ok=True)
  return worker.SCENARIOS[scenario](worker.single_mesh, work_dir)


def _assert_gang_equals_single(results, want):
  """Every rank's arrays equal the single-process mesh's, bit for bit."""
  for r, got in enumerate(results):
    assert sorted(got) == sorted(want), r
    for key in want:
      np.testing.assert_array_equal(got[key], want[key],
                                    err_msg=f'rank {r}: {key}')


# --- Unit tests, no gang -------------------------------------------------


def test_mesh_ranks_local_cells_and_first_device(monkeypatch):
  monkeypatch.setattr(distributed.dist, 'get_rank', lambda: 1)
  mesh = t_mesh.default_mesh(['cpu'] * 4, 2, 2, ranks=[0, 0, 1, 1])
  assert mesh.is_multiprocess and distributed.is_multiprocess_mesh(mesh)
  assert mesh.ranks == ((0, 0), (1, 1))
  assert mesh.local_cells == [(1, 0), (1, 1)]
  assert not mesh.is_local(0, 1) and mesh.is_local(1, 0)
  assert mesh.home(1) == torch.device('cpu')
  assert mesh.first_device == torch.device('cpu')
  assert distributed.shard_exchange(mesh, 1) is None
  monkeypatch.setattr(distributed.dist, 'get_rank', lambda: 0)
  across = t_mesh.Mesh([['cpu', 'cpu']], ranks=[[0, 1]])
  assert across.local_cells == [(0, 0)]
  assert distributed.shard_exchange(across, 0) is not None
  single = t_mesh.default_mesh(['cpu'] * 2)
  assert not single.is_multiprocess and single.ranks is None
  assert single.local_cells == [(0, 0), (1, 0)]
  assert t_mesh.check_mesh(mesh) is mesh
  blocks = distributed.make_global(torch.arange(8.0), mesh)
  assert blocks[0] is None and torch.equal(blocks[1], torch.arange(4.0, 8.0))
  with pytest.raises(ValueError, match='members do not split'):
    distributed.make_global(torch.arange(3.0), mesh)
  with pytest.raises(ValueError, match='not a grid'):
    t_mesh.Mesh([['cpu', 'cpu']], ranks=[[0]])
  monkeypatch.setattr(distributed.dist, 'get_rank', lambda: 1)
  with pytest.raises(ValueError, match='holds no cell'):
    t_mesh.Mesh([['cpu']], ranks=[[0]])


def test_multihost_mesh_layout_and_its_errors(monkeypatch):
  """The JAX layout: rank 0's devices, then rank 1's, in rows of
  `data_devices_per_host`; each data row within one rank."""
  with pytest.raises(ValueError, match='must divide local device count 3'):
    distributed.multihost_mesh(2, local_devices=['cpu'] * 3)
  monkeypatch.setattr(distributed.dist, 'get_world_size', lambda: 2)
  monkeypatch.setattr(distributed.dist, 'get_rank', lambda: 1)

  def all_gather_object(out, obj):
    out[:] = [obj, obj]

  monkeypatch.setattr(distributed.dist, 'all_gather_object',
                      all_gather_object)
  mesh = distributed.multihost_mesh(2, local_devices=['cpu'] * 4)
  assert mesh.shape == {'ens': 4, 'data': 2}
  assert mesh.ranks == ((0, 0), (0, 0), (1, 1), (1, 1))
  assert mesh.rank == 1 and mesh.local_cells[0] == (2, 0)
  one = distributed.multihost_mesh(local_devices=['cpu'])
  assert one.shape == {'ens': 2, 'data': 1} and one.ranks == ((0,), (1,))


def test_initialize_is_a_no_op_once_joined(monkeypatch):
  calls = []
  monkeypatch.setattr(distributed.dist, 'is_initialized', lambda: True)
  monkeypatch.setattr(distributed.dist, 'init_process_group',
                      lambda *a, **k: calls.append((a, k)))
  distributed.initialize('localhost:1', 2, 0)
  assert not calls
  monkeypatch.setattr(distributed.dist, 'is_initialized', lambda: False)
  distributed.initialize('localhost:1', 2, 1, backend='gloo')
  (args, kwargs), = calls
  assert args == ('gloo',) and kwargs['init_method'] == 'tcp://localhost:1'
  assert (kwargs['world_size'], kwargs['rank']) == (2, 1)
  assert kwargs['timeout'] == distributed.DEFAULT_TIMEOUT


@pytest.mark.parametrize(
    'cards, local_ranks, world, want',
    [(0, None, 2, 'gloo'),       # no CUDA device
     (4, 4, 8, 'nccl'),          # torchrun: two hosts of 4 cards, a card a rank
     (1, 2, 2, 'gloo'),          # torchrun: two ranks on one card
     (4, None, 4, 'nccl'),       # by hand: no more ranks than this host's cards
     (4, None, 8, ValueError),   # by hand: more ranks than cards, host unknown
     (1, None, 2, ValueError)])
def test_default_backend_rule(monkeypatch, cards, local_ranks, world, want):
  monkeypatch.setattr(distributed.torch.cuda, 'is_available', lambda: cards > 0)
  monkeypatch.setattr(distributed.torch.cuda, 'device_count', lambda: cards)
  monkeypatch.setattr(distributed.dist, 'is_nccl_available', lambda: True)
  if want is ValueError:
    with pytest.raises(ValueError, match='pass `backend`'):
      distributed.default_backend(local_ranks, world)
  else:
    assert distributed.default_backend(local_ranks, world) == want


# --- The gang ---------------------------------------------------------------


def test_two_ranks_equal_the_single_process_mesh(tmp_path):
  """MAP and VI over both layouts, a minibatch and the predicts: rank-equal
  and bit for bit the single-process mesh's; the predict within the JAX
  package's bounds; the saved artifact loads meshless in one process."""
  gang_dir = tmp_path / 'gang'
  gang_dir.mkdir()
  results = _run_gang(2, 'tier1', str(gang_dir))
  want = _single_process('tier1', str(tmp_path / 'single'))
  _assert_gang_equals_single(results, want)
  assert want['map-1x2/losses'].shape == (2, 2, 3)
  assert want['vi-2x1/draws/0'].shape == (2, 3, 2)
  assert np.isfinite(want['map-1x2/losses']).all()

  config = j_field.FieldConfig.create(**worker.PREDICT_CONFIG)
  arrays, x = worker.predict_inputs(j_field.param_specs(config))
  means, quantiles = j_predict.predict_bnf(
      x, 'NORMAL', tuple(jnp.asarray(a) for a in arrays), config,
      worker.QUANTILES, ensemble_dims=2, chunk_size=worker.PREDICT_CHUNK,
      backend='xla')
  got = results[0]
  np.testing.assert_allclose(got['predict-1x2/means'], np.asarray(means),
                             **MEANS_TOL)
  noise = 0.01 + np.exp(arrays[0].max())
  for i, q in enumerate(quantiles):
    np.testing.assert_allclose(got[f'predict-1x2/quantiles/{i}'],
                               np.asarray(q), rtol=2e-5, atol=1e-4 * noise)

  est = bayesnf_torch.BayesianNeuralFieldEstimator.load(
      str(gang_dir / 'map-2x1.npz'), device='cpu')
  assert est.mesh_ is None
  for i, p in enumerate(est.params_):
    np.testing.assert_array_equal(p.numpy(), want[f'map-2x1/params/{i}'])


@pytest.mark.slow
def test_streamed_fits_and_predict_across_ranks(tmp_path):
  results = _run_gang(2, 'streamed', str(tmp_path))
  want = _single_process('streamed', str(tmp_path / 'single'))
  _assert_gang_equals_single(results, want)
  for key in want:
    if key.startswith('predict-stream/'):
      np.testing.assert_array_equal(
          want[key], want[key.replace('predict-stream/', 'predict/')])
  assert not np.array_equal(want['map-stream/losses'],
                            want['map-remix/losses'])


@pytest.mark.slow
def test_checkpoint_resume_across_ranks(tmp_path):
  results = _run_gang(2, 'checkpointed', str(tmp_path))
  assert sorted(os.listdir(tmp_path / 'ckpt-map' / 'split_0')) == [
      'fingerprint.json', 'step_3.pt', 'step_4.pt']
  want = _single_process('checkpointed', str(tmp_path / 'single'))
  _assert_gang_equals_single(results, want)
  for key in want:
    if '-resumed/' in key:
      np.testing.assert_array_equal(
          want[key], want[key.replace('-resumed/', '-straight/')])


@pytest.mark.slow
def test_four_rank_grid(tmp_path):
  results = _run_gang(4, 'grid', str(tmp_path))
  _assert_gang_equals_single(
      results, _single_process('grid', str(tmp_path / 'single')))
