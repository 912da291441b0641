"""The port's K2 forward (`bayesnf_torch.ops.fused_mlp`) against the JAX one.

On the CPU the JAX kernel runs in Pallas interpret mode, as in
`tests/test_fused_mlp.py`, and the port's plain PyTorch version must match
it to rtol/atol 2e-5 (the JAX package's own forward bound). The CUDA kernel
itself is compared with the plain version on the card by
`tests/test_torch_gpu.py` and by `chip_smoke.py` at the main path's shapes.

The host code of K2, K3, K4a and K4b (`csrc/fused_mlp_t.cu`, layer-wise
over chunks of whole 128-row tiles, both layouts through one pair of C
entries) runs here against a stand-in for the compiled library: the chunk
plan under `TRAIN_SCRATCH_BYTES` and the arguments each launch passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.profiler

from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_torch.utils import profiling
from bayesnf_tpu.ops import fused_mlp as j_fused

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(depth, groups, n, width=16, members=2, seed=0):
  rng = np.random.default_rng(seed)
  f = sum(groups)
  fan_ins = [f] + [width] * depth
  fan_outs = [width] * depth + [1]
  return dict(
      h0_groups=[rng.uniform(-1, 1, (members, g, n)).astype(np.float32)
                 for g in groups],
      weights=[np.clip(rng.normal(size=(members, fi, fo)), -2, 2)
               .astype(np.float32) for fi, fo in zip(fan_ins, fan_outs)],
      biases=[rng.normal(scale=0.3, size=(members, fo)).astype(np.float32)
              for fo in fan_outs],
      scales_raw=rng.normal(scale=0.5, size=(members, depth + 1))
      .astype(np.float32),
      logit=rng.normal(size=(members,)).astype(np.float32),
  )


def _as(convert, args):
  return {k: [convert(a) for a in v] if isinstance(v, list) else convert(v)
          for k, v in args.items()}


def _torch_args(args, device='cpu'):
  return _as(lambda a: torch.as_tensor(a, device=device), args)


@pytest.mark.parametrize('depth', [1, 2, 3])
@pytest.mark.parametrize('groups', [(9,), (3, 6)])
def test_reference_matches_pallas_interpret(depth, groups):
  args = _inputs(depth, groups, n=77)  # ragged: 77 rows in 32-row tiles.
  j = _as(jnp.asarray, args)
  want = j_fused.fused_field_mlp_t(
      depth, 32, 'f32', tuple(j['h0_groups']), tuple(j['weights']),
      tuple(j['biases']), j['scales_raw'], j['logit'])
  got = t_fused.fused_field_mlp_t_reference(depth, **_torch_args(args))
  assert got.shape == (2, 77)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_on_cpu_is_the_plain_version():
  args = _torch_args(_inputs(2, (4, 5), n=20))
  before = t_fused.fused_field_mlp_t.launches
  got = t_fused.fused_field_mlp_t(2, **args)
  assert t_fused.fused_field_mlp_t.launches == before
  assert torch.equal(got, t_fused.fused_field_mlp_t_reference(2, **args))


def test_wrapper_refuses_other_devices():
  args = _torch_args(_inputs(1, (5,), n=8), device='meta')
  with pytest.raises(ValueError, match='CUDA or CPU'):
    t_fused.fused_field_mlp_t(1, **args)


def test_input_checks():
  args = _torch_args(_inputs(2, (6,), n=10))
  h0 = args.pop('h0_groups')[0]
  width = t_fused._check_inputs(2, h0, **args)  # pylint: disable=protected-access
  assert width == 16
  bad_shape = dict(args, biases=[b[:, :-1] for b in args['biases']])
  with pytest.raises(ValueError, match='shape'):
    t_fused._check_inputs(2, h0, **bad_shape)  # pylint: disable=protected-access
  with pytest.raises(ValueError, match='float32'):
    t_fused._check_inputs(2, h0.double(), **args)  # pylint: disable=protected-access
  with pytest.raises(ValueError, match='contiguous'):
    t_fused._check_inputs(  # pylint: disable=protected-access
        2, h0.transpose(1, 2).contiguous().transpose(1, 2), **args)
  with pytest.raises(ValueError, match='weights and biases'):
    t_fused._check_inputs(1, h0, **args)  # pylint: disable=protected-access
  with pytest.raises(ValueError, match='depth'):
    t_fused._check_inputs(  # pylint: disable=protected-access
        t_fused.MAX_DEPTH + 1, h0, **args)


class _FakeFieldLib:
  """Stands in for the compiled field-MLP library on the CPU: the C side's
  scratch formula (per chunk row and member: the forward's lhs_0 and two
  ping-pong width buffers, the backward's lhs_l, z_l and dv_l; under 'bf16'
  their bf16 twins, and per member the hidden weights' bf16 copies, rows
  padded to a multiple of 8; the backward's partials per 128-row tile; the
  same in both layouts), and launches that record their arguments and
  return `err`. The entries' trailing arguments, after the host arrays:
  rsqrts, layout, precision, depth, members, features, width, rows, chunk
  rows and the stream."""

  def __init__(self, err=0):
    self.err = err
    self.calls = []

  @staticmethod
  def bnf_fused_mlp_t_scratch_bytes(members, f, width, depth, chunk_rows,
                                    n_rows, precision, backward):
    if depth == 0:
      width = f
    tiles = -(-n_rows // 128)
    if backward:
      floats = f + 3 * depth * width + 1
      twins = f + (2 * depth - 1) * width if depth else 0
      partials = tiles * (1 + 2 * depth * -(-width // 128))
    else:
      floats = f + min(depth, 2) * width
      twins = f + min(depth - 1, 2) * width if depth else 0
      partials = 0
    copies = (f + (depth - 1) * width) * (-(-width // 8) * 8) if depth else 0
    bf16 = (chunk_rows * twins + copies) * 2 if precision == 1 else 0
    return members * ((chunk_rows * floats + partials) * 4 + bf16)

  TRAILING = ('rsqrts', 'layout', 'precision', 'depth', 'members',
              'features', 'width', 'rows', 'chunk_rows', 'stream')

  def _record(self, args):
    self.calls.append(dict(zip(self.TRAILING, args[-len(self.TRAILING):])))
    return self.err

  def bnf_fused_mlp_t_fwd(self, *args):
    return self._record(args)

  def bnf_fused_mlp_t_bwd(self, *args):
    return self._record(args)

  @staticmethod
  def bnf_cuda_error_string(err):
    return f'error {err}'.encode()


def _plan(members, f, width, depth, n, precision, backward):
  lib = _FakeFieldLib()
  code = t_fused.PRECISION_CODES[precision]
  return t_fused._chunk_rows(  # pylint: disable=protected-access
      lambda rows, total: lib.bnf_fused_mlp_t_scratch_bytes(
          members, f, width, depth, rows, total, code, backward), n)


@pytest.mark.parametrize('backward', [0, 1], ids=['k2', 'k3'])
@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_k2_k3_chunks_are_whole_tiles_under_the_budget(monkeypatch, backward,
                                                       precision):
  # A budget of 300 rows' scratch (beside the weights' copies) gives
  # 256-row chunks of 700 rows (the C side runs the ragged last one); less
  # than one tile's gives 128-row chunks; an ample one a single chunk of
  # 700 rounded up to whole tiles.
  lib = _FakeFieldLib()
  code = t_fused.PRECISION_CODES[precision]
  fixed = lib.bnf_fused_mlp_t_scratch_bytes(3, 19, 40, 2, 0, 0, code,
                                            backward)
  per_row = lib.bnf_fused_mlp_t_scratch_bytes(3, 19, 40, 2, 1, 0, code,
                                              backward) - fixed
  for budget_rows, chunk in ((300, 256), (40, 128), (10_000, 768)):
    monkeypatch.setattr(t_fused, 'TRAIN_SCRATCH_BYTES',
                        fixed + budget_rows * per_row)
    assert _plan(3, 19, 40, 2, 700, precision, backward) == chunk


def test_k2_k3_chunk_plan_of_a_480_member_predict():
  # Phase 7's VI predict: 480 members of width 512 over 4,096 rows at the
  # default 2 GiB budget run in several chunks of whole tiles; a forward
  # holds fewer buffers a row than a backward, so its chunks are longer.
  assert t_fused.TRAIN_SCRATCH_BYTES == 2 << 30
  fwd = _plan(480, 49, 512, 2, 4096, 'f32', 0)
  bwd = _plan(480, 49, 512, 2, 4096, 'f32', 1)
  for chunk in (fwd, bwd):
    assert chunk % 128 == 0 and 128 <= chunk < 4096
  assert -(-4096 // fwd) > 1 and bwd < fwd
  assert (fwd, bwd) == (1024, 256)
  # 64 members (phase 5's serving chunk) take their 4,096 rows at once.
  assert _plan(64, 49, 512, 2, 4096, 'f32', 0) == 4096


@pytest.mark.parametrize('layout, counted', [('features', True),
                                             ('rows', False)])
def test_k2_counts_its_row_chunks_while_a_profiler_records(layout, counted):
  # 1,920 members of width 512 and F = 79 (the wind stanza's VI predict)
  # over a 4,096-row chunk: the plan's 128-row chunks, counted only for
  # K2 (features-major) and only while a profiler records.
  members, f, width, n = 1920, 79, 512, 4096
  plan = _plan(members, f, width, 2, n, 'f32', 0)
  assert plan == 128
  h0 = torch.empty((members, f, n) if layout == 'features'
                   else (members, n, f), device='meta')
  fan = [(f, width), (width, width), (width, 1)]
  params = ([torch.empty((members, i, o), device='meta') for i, o in fan],
            [torch.empty((members, o), device='meta') for _, o in fan],
            torch.empty((members, 3), device='meta'),
            torch.empty(members, device='meta'))
  lib = _FakeFieldLib()

  def launch():
    t_fused._launch_k2(  # pylint: disable=protected-access
        lib, 'stream', layout, 2, 'f32', width, h0, *params)

  profiling.reset()
  launch()
  assert profiling.counters() == {}
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    launch()
    launch()
  counts = profiling.counters()
  profiling.reset()
  assert counts == ({t_fused.K2_ROW_CHUNKS: 2 * n // plan} if counted
                    else {})
  assert [c['chunk_rows'] for c in lib.calls] == [plan] * 3


def _launch_call(lib, layout, precision, h0, params, g=None):
  """The last launch's recorded arguments, as `_FakeFieldLib` names them,
  and what the wrapper returned."""
  if g is None:
    got = t_fused._launch_k2(  # pylint: disable=protected-access
        lib, 'stream', layout, 2, precision, 16, h0, *params)
  else:
    got = t_fused._launch_k3(  # pylint: disable=protected-access
        lib, 'stream', layout, 2, precision, 16, h0, *params, g)
  call = dict(lib.calls[-1])
  rsqrts = list(call.pop('rsqrts'))
  np.testing.assert_allclose(rsqrts, [9 ** -0.5, 0.25, 0.25], rtol=1e-7)
  return call, got


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_k2_and_k3_launches_pass_the_plan_and_the_shapes(precision):
  args = _torch_args(_inputs(2, (6, 3), n=300, width=16, members=3))
  h0 = torch.cat(args.pop('h0_groups'), 1)
  params = (args['weights'], args['biases'], args['scales_raw'],
            args['logit'])
  want = dict(layout=0, precision=t_fused.PRECISION_CODES[precision],
              depth=2, members=3, features=9, width=16, rows=300,
              chunk_rows=384, stream='stream')
  lib = _FakeFieldLib()
  call, out = _launch_call(lib, 'features', precision, h0, params)
  assert call == want and out.shape == (3, 300)
  g = torch.ones((3, 300))
  call, (dh0, dws, dbs, dscales, dlogit) = _launch_call(
      lib, 'features', precision, h0, params, g)
  assert call == want
  assert dh0.shape == h0.shape
  assert [t.shape for t in (*dws, *dbs, dscales, dlogit)] == [
      t.shape for t in (*args['weights'], *args['biases'],
                        args['scales_raw'], args['logit'])]
  with pytest.raises(RuntimeError, match='fused_field_mlp_t kernel launch '
                     'failed: CUDA error 7 .error 7'):
    _launch_call(_FakeFieldLib(err=7), 'features', precision, h0, params)
  with pytest.raises(RuntimeError, match='fused_field_mlp_t backward kernel '
                     'launch failed'):
    _launch_call(_FakeFieldLib(err=2000), 'features', precision, h0, params,
                 g)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
def test_k4a_and_k4b_launches_pass_the_plan_and_the_shapes(precision):
  # A row-major call reaches the same C entries with layout 1, plans the
  # chunks of the features-major call of the same shape (the scratch is
  # (E, F, ld) in both layouts) and returns dh0 as (E, N, F).
  args = _torch_args(_inputs(2, (6, 3), n=300, width=16, members=3))
  h0_t = torch.cat(args.pop('h0_groups'), 1)
  h0 = h0_t.transpose(1, 2).contiguous()
  params = (args['weights'], args['biases'], args['scales_raw'],
            args['logit'])
  lib = _FakeFieldLib()
  features, _ = _launch_call(lib, 'features', precision, h0_t, params)
  call, out = _launch_call(lib, 'rows', precision, h0, params)
  assert call == dict(features, layout=1) and out.shape == (3, 300)
  g = torch.ones((3, 300))
  features, _ = _launch_call(lib, 'features', precision, h0_t, params, g)
  call, (dh0, dws, dbs, dscales, dlogit) = _launch_call(
      lib, 'rows', precision, h0, params, g)
  assert call == dict(features, layout=1)
  assert dh0.shape == (3, 300, 9)
  assert [t.shape for t in (*dws, *dbs, dscales, dlogit)] == [
      t.shape for t in (*args['weights'], *args['biases'],
                        args['scales_raw'], args['logit'])]
  with pytest.raises(RuntimeError, match='fused_field_mlp kernel launch '
                     'failed: CUDA error 7 .error 7'):
    _launch_call(_FakeFieldLib(err=7), 'rows', precision, h0, params)
  with pytest.raises(RuntimeError, match='fused_field_mlp backward kernel '
                     'launch failed: CUDA error 2000'):
    _launch_call(_FakeFieldLib(err=2000), 'rows', precision, h0, params, g)
