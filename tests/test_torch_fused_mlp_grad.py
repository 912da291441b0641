"""The port's differentiable field MLP against the JAX package's custom VJPs.

The plain versions of K3 and K4b (`fused_field_mlp_t_vjp_reference`,
`fused_field_mlp_vjp_reference`: autograd through the plain forwards) take
the same numpy inputs as `jax.vjp` of `fused_field_mlp_t` and
`fused_field_mlp`, whose backward runs the Pallas kernels `_backward_kernel_t`
and `_backward_kernel` in interpret mode (tile 32, as
`tests/test_fused_mlp.py`). Bounds: each forward to 2e-5 and each gradient
leaf to rtol/atol 5e-4 (the JAX package's own, `tests/test_fused_mlp.py`);
'highest' equals 'f32'; at 'bf16' both round the same fp32 values at the
same sites, so each leaf agrees within 2e-3 of its largest magnitude
(values an ulp apart may round to neighbouring bf16 values). The row-major
model (`field.encode`, `field.apply_field`) and its gradients are held to
`jax.vmap` of the JAX functions and `jax.grad` at 2e-5 and 5e-4. The CUDA
kernels themselves are compared with these plain versions on the card by
`tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import test_torch_field
import torch

import bayesnf_torch
from bayesnf_torch import models as t_models
from bayesnf_torch.models import field as t_field
from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_tpu import models as j_models
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.ops import fused_mlp as j_fused

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_LEAF_TOL = 2e-3
TILE = 32


def _inputs(depth, groups, n, width=16, members=3, seed=0):
  """Numpy inputs of one call, features-major groups, and a cotangent."""
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
      g=rng.normal(size=(members, n)).astype(np.float32),
  )


def _row_major(args):
  """The same inputs with h0 as one (E, N, F) array."""
  return dict(args, h0=np.ascontiguousarray(
      np.concatenate(args['h0_groups'], 1).transpose(0, 2, 1)))


def _jax_vjp(fn, depth, precision, h0, args):
  """(pred, (dh0, dweights, dbiases, dscales, dlogit)) of the JAX function."""
  j = lambda a: jnp.asarray(a)  # pylint: disable=unnecessary-lambda-assignment
  primals = (h0, tuple(map(j, args['weights'])), tuple(map(j, args['biases'])),
             j(args['scales_raw']), j(args['logit']))
  pred, vjp = jax.vjp(
      lambda *p: fn(depth, TILE, precision, *p), *primals)
  return pred, vjp(j(args['g']))


def _jax_t(depth, args, precision='f32'):
  return _jax_vjp(j_fused.fused_field_mlp_t, depth, precision,
                  tuple(map(jnp.asarray, args['h0_groups'])), args)


def _jax_rows(depth, args, precision='f32'):
  return _jax_vjp(j_fused.fused_field_mlp, depth, precision,
                  jnp.asarray(args['h0']), args)


def _t(args, key):
  value = args[key]
  if isinstance(value, list):
    return [torch.as_tensor(v) for v in value]
  return torch.as_tensor(value)


def _port_t(depth, args, precision='f32'):
  call = [depth, _t(args, 'h0_groups'), _t(args, 'weights'),
          _t(args, 'biases'), _t(args, 'scales_raw'), _t(args, 'logit')]
  return (t_fused.fused_field_mlp_t_reference(*call, precision),
          t_fused.fused_field_mlp_t_vjp_reference(*call, _t(args, 'g'),
                                                  precision))


def _port_rows(depth, args, precision='f32'):
  call = [depth, _t(args, 'h0'), _t(args, 'weights'), _t(args, 'biases'),
          _t(args, 'scales_raw'), _t(args, 'logit')]
  return (t_fused.fused_field_mlp_reference(*call, precision),
          t_fused.fused_field_mlp_vjp_reference(*call, _t(args, 'g'),
                                                precision))


def _leaves(grads):
  """The VJP's gradients as one flat list (dh0 per group first)."""
  dh0, dws, dbs, dscales, dlogit = grads
  dh0 = list(dh0) if isinstance(dh0, (tuple, list)) else [dh0]
  return [*dh0, *dws, *dbs, dscales, dlogit]


def _assert_vjp_close(port, jax_out, fwd_tol, leaf_check):
  (pred, grads), (j_pred, j_grads) = port, jax_out
  np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), **fwd_tol)
  got, want = _leaves(grads), _leaves(j_grads)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    w = np.asarray(w).reshape(tuple(g.shape))
    leaf_check(g.numpy(), w)


def _close(g, w):
  np.testing.assert_allclose(g, w, **GRAD_TOL)


def _bf16_close(g, w):
  assert np.abs(g - w).max() <= BF16_LEAF_TOL * np.abs(w).max()


@pytest.mark.parametrize('depth', [1, 2, 3])
@pytest.mark.parametrize('groups', [(9,), (3, 6)])
def test_features_major_vjp_matches_pallas_interpret(depth, groups):
  args = _inputs(depth, groups, n=77)  # ragged: 77 rows in 32-row tiles.
  _assert_vjp_close(_port_t(depth, args), _jax_t(depth, args), FWD_TOL,
                    _close)


@pytest.mark.parametrize('depth', [1, 2, 3])
@pytest.mark.parametrize('groups', [(9,), (3, 6)])
def test_row_major_forward_and_vjp_match_pallas_interpret(depth, groups):
  args = _row_major(_inputs(depth, groups, n=50))  # ragged in 32-row tiles
  _assert_vjp_close(_port_rows(depth, args), _jax_rows(depth, args), FWD_TOL,
                    _close)


@pytest.mark.parametrize('layout', ['features', 'rows'])
def test_highest_is_f32(layout):
  args = _row_major(_inputs(2, (3, 6), n=40))
  port = _port_t if layout == 'features' else _port_rows
  (p32, g32), (ph, gh) = port(2, args), port(2, args, 'highest')
  assert torch.equal(p32, ph)
  assert all(torch.equal(a, b) for a, b in zip(_leaves(g32), _leaves(gh)))


@pytest.mark.parametrize('depth', [0, 1, 2])
@pytest.mark.parametrize('layout', ['features', 'rows'])
def test_bf16_matches_pallas_interpret_bf16(layout, depth):
  args = _row_major(_inputs(depth, (3, 6), n=64, seed=depth + 3))
  if layout == 'features':
    port, want = _port_t(depth, args, 'bf16'), _jax_t(depth, args, 'bf16')
  else:
    port, want = _port_rows(depth, args, 'bf16'), _jax_rows(depth, args,
                                                            'bf16')
  pred, j_pred = port[0].numpy(), np.asarray(want[0])
  assert np.abs(pred - j_pred).max() <= BF16_LEAF_TOL * np.abs(j_pred).max()
  _assert_vjp_close(port, want, dict(rtol=1, atol=np.inf), _bf16_close)


def test_row_major_bf16_keeps_the_output_product_fp32():
  # Row-major, the output layer's h @ W_out has a result of last dimension
  # 1, so the Pallas kernel keeps it fp32 where the features-major one
  # rounds it. At depth 0 it is the only forward product: the row-major
  # 'bf16' prediction is the fp32 one bit for bit (and the interpreter's
  # agrees with it to fp32 rounding), the features-major one is not.
  args = _row_major(_inputs(0, (3, 6), n=64, seed=5))
  rows_bf16, _ = _port_rows(0, args, 'bf16')
  rows_f32, _ = _port_rows(0, args)
  assert torch.equal(rows_bf16, rows_f32)
  np.testing.assert_allclose(rows_bf16.numpy(),
                             np.asarray(_jax_rows(0, args, 'bf16')[0]),
                             rtol=1e-6, atol=1e-6)
  features_bf16, _ = _port_t(0, args, 'bf16')
  assert (features_bf16 - rows_f32).abs().max() > 1e-4
  # At depth 2 the row-major 'bf16' prediction follows the interpreter's
  # far closer than a rounded output product could (~1e-3 of its scale).
  args = _row_major(_inputs(2, (3, 6), n=64, seed=6))
  pred, _ = _port_rows(2, args, 'bf16')
  want = np.asarray(_jax_rows(2, args, 'bf16')[0])
  assert np.abs(pred.numpy() - want).max() <= 2e-5 * np.abs(want).max()


def test_row_major_bf16_one_feature_keeps_dh0_fp32():
  # With F = 1 the first layer's dv @ W_0^T has a result of last dimension
  # 1 and stays fp32 row-major (it rounds features-major).
  args = _row_major(_inputs(1, (1,), n=40, seed=7))
  _assert_vjp_close(_port_rows(1, args, 'bf16'), _jax_rows(1, args, 'bf16'),
                    dict(rtol=1e-5, atol=1e-5), _bf16_close)
  (_, rows), (_, features) = _port_rows(1, args, 'bf16'), _port_t(
      1, args, 'bf16')
  assert not torch.allclose(rows[0], features[0][0].transpose(1, 2),
                            rtol=1e-6, atol=0)


@pytest.mark.parametrize('layout', ['features', 'rows'])
def test_wrappers_on_cpu_are_the_plain_versions(layout):
  args = _row_major(_inputs(2, (4, 5), n=30))
  fn, vjp = {'features': (t_fused.fused_field_mlp_t,
                          t_fused.fused_field_mlp_t_vjp),
             'rows': (t_fused.fused_field_mlp, t_fused.fused_field_mlp_vjp)
             }[layout]
  h0 = _t(args, 'h0_groups') if layout == 'features' else [_t(args, 'h0')]
  leaves = [t.requires_grad_(True) for t in (
      *h0, *_t(args, 'weights'), *_t(args, 'biases'), _t(args, 'scales_raw'),
      _t(args, 'logit'))]
  before = (fn.launches, fn.bwd_launches)
  call = (2, leaves[:len(h0)] if layout == 'features' else leaves[0],
          leaves[len(h0):len(h0) + 3], leaves[len(h0) + 3:len(h0) + 6],
          leaves[-2], leaves[-1])
  grads = torch.autograd.grad(fn(*call), leaves, _t(args, 'g'))
  plain = [t.detach() for t in leaves]
  direct = vjp(2, plain[:len(h0)] if layout == 'features' else plain[0],
               plain[len(h0):len(h0) + 3], plain[len(h0) + 3:len(h0) + 6],
               plain[-2], plain[-1], _t(args, 'g'))
  want = (_port_t if layout == 'features' else _port_rows)(2, args)[1]
  assert (fn.launches, fn.bwd_launches) == before
  for got, d, w in zip(grads, _leaves(direct), _leaves(want)):
    assert torch.equal(got, w) and torch.equal(d, w)


def test_wrappers_refuse_unknown_precisions_and_devices():
  args = _row_major(_inputs(1, (5,), n=8))
  call = (1, _t(args, 'h0'), _t(args, 'weights'), _t(args, 'biases'),
          _t(args, 'scales_raw'), _t(args, 'logit'))
  with pytest.raises(ValueError, match='Unknown precision'):
    t_fused.fused_field_mlp(*call, precision='fp16')
  meta = [t.to('meta') if isinstance(t, torch.Tensor) else
          [w.to('meta') for w in t] for t in call[1:]]
  with pytest.raises(ValueError, match='CUDA or CPU'):
    t_fused.fused_field_mlp(1, *meta)
  with pytest.raises(ValueError, match='CUDA or CPU'):
    t_fused.fused_field_mlp_vjp(1, *meta, _t(args, 'g').to('meta'))


def test_predict_builds_no_graph_and_launches_no_backward():
  model = bayesnf_torch.BayesianNeuralFieldMAP.load(
      str(DATA / 'bnf-map.chickenpox.8.port.npz'), device='cpu')
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  before = (t_fused.fused_field_mlp_t.launches,
            t_fused.fused_field_mlp_t.bwd_launches)
  means, quantiles = model.predict(table, quantiles=(0.5,))
  assert means.grad_fn is None and quantiles[0].grad_fn is None
  assert (t_fused.fused_field_mlp_t.launches,
          t_fused.fused_field_mlp_t.bwd_launches) == before


# --- The row-major model: encode and apply_field against jax.vmap.


# pylint: disable=protected-access
def _model(name, members, n, seed):
  j_cfg, t_cfg = test_torch_field._configs(name)
  arrays = test_torch_field._numpy_params(j_cfg, members, seed)
  x = test_torch_field._inputs(j_cfg, n, seed + 1)
  seasonal = np.array(j_field.seasonal_features_for(j_cfg, jnp.asarray(x)))
  return j_cfg, t_cfg, arrays, x, seasonal


@pytest.mark.parametrize('name', sorted(test_torch_field.CONFIGS))
def test_encode_matches_vmap(name):
  j_cfg, t_cfg, arrays, x, seasonal = _model(name, 3, 41, seed=2)
  want = jax.vmap(lambda p: j_field.encode(
      j_cfg, p, jnp.asarray(x), jnp.asarray(seasonal)))(
          tuple(jnp.asarray(a) for a in arrays))
  got = t_field.encode(t_cfg, t_field.params_from_numpy(t_cfg, arrays, 1,
                                                        'cpu'),
                       torch.from_numpy(x), torch.from_numpy(seasonal))
  assert got.shape == (3, 41, t_cfg.encoded_dim)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize('name', sorted(test_torch_field.CONFIGS))
def test_apply_field_and_its_gradients_match_vmap_and_grad(name):
  j_cfg, t_cfg, arrays, x, seasonal = _model(name, 2, 37, seed=4)
  weights = np.random.default_rng(5).normal(size=(2, 37)).astype(np.float32)

  def j_loss(params):
    pred = jax.vmap(j_models.apply_field, (None, 0, None, None))(
        j_cfg, params, jnp.asarray(x), jnp.asarray(seasonal))
    return jnp.sum(pred * weights), pred

  j_params = tuple(jnp.asarray(a) for a in arrays)
  (_, want), want_grads = jax.value_and_grad(j_loss, has_aux=True)(j_params)
  params = [p.requires_grad_(True)
            for p in t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu')]
  pred = t_models.apply_field(t_cfg, params, torch.from_numpy(x),
                              torch.from_numpy(seasonal))
  assert pred.shape == (2, 37)
  np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                             **FWD_TOL)
  # The observation scalars are not read: their gradients are zero.
  grads = torch.autograd.grad((pred * torch.from_numpy(weights)).sum(),
                              params, allow_unused=True,
                              materialize_grads=True)
  for spec, g, w in zip(t_field.param_specs(t_cfg), grads, want_grads):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=spec.name,
                               **GRAD_TOL)


@pytest.mark.parametrize('groups', [2, 1], ids=['per-member', 'one-group'])
def test_grouped_row_major_inputs_match_vmap(groups):
  # x (G, N, D): member m reads row set m // (E / G), as the
  # features-major encode does.
  j_cfg, t_cfg, arrays, _, _ = _model('seasonal+interactions', 2, 23, seed=6)
  xs = np.stack([test_torch_field._inputs(j_cfg, 23, 7 + i)
                 for i in range(groups)])
  seas = np.stack([np.array(j_field.seasonal_features_for(
      j_cfg, jnp.asarray(v))) for v in xs])
  member = np.arange(2) // (2 // groups)
  want = jax.vmap(lambda p, a, s: j_field.apply_field(j_cfg, p, a, s))(
      tuple(jnp.asarray(a) for a in arrays), jnp.asarray(xs[member]),
      jnp.asarray(seas[member]))
  got = t_field.apply_field(
      t_cfg, t_field.params_from_numpy(t_cfg, arrays, 1, 'cpu'),
      torch.from_numpy(xs), torch.from_numpy(seas))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_models_exports_the_jax_packages_names():
  assert t_models.__all__ == j_models.__all__
  for name in t_models.__all__:
    assert getattr(t_models, name).__name__ == getattr(j_models,
                                                       name).__name__
