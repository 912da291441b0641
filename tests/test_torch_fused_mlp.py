"""The port's K2 forward (`bayesnf_torch.ops.fused_mlp`) against the JAX one.

On the CPU the JAX kernel runs in Pallas interpret mode, as in
`tests/test_fused_mlp.py`, and the port's plain PyTorch version must match
it to rtol/atol 2e-5 (the JAX package's own forward bound). The CUDA kernel
itself is compared with the plain version on the card by
`tests/test_torch_gpu.py` and by `chip_smoke.py` at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.ops import fused_mlp as t_fused
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
