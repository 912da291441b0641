"""The port's precision tiers (`bayesnf_torch.ops.mixed`) against the JAX
package's `bayesnf_tpu.ops.mixed`.

`matmul_bf16`'s forward and both gradients take the same numpy inputs as the
JAX `matmul_bf16` under `jax.grad`, on the cases of `tests/test_mixed.py`
(plain, and batched over members as the JAX test's `vmap`). Both sides round
the same fp32 operands to bf16 and sum exact products in fp32, so they
differ only by the order of the sums: rtol 1e-5 / atol 1e-5 on values of
order 10. Against true fp32 products they differ at the bf16 scale
(`tests/test_mixed.py`'s 3e-2 and 5e-2). 'highest' is 'f32' bit for bit, and
`fp32_matmuls` pins fp32 whatever the caller set, then gives the setting
back.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.ops import mixed as t_mixed
from bayesnf_tpu.ops import mixed as j_mixed

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PARITY = dict(rtol=1e-5, atol=1e-5)
# (a shape, b shape): tests/test_mixed.py's plain and vmapped cases.
SHAPES = {'plain': ((40, 24), (24, 8)), 'batched': ((4, 10, 6), (4, 6, 3))}


def _inputs(name, seed=1):
  (a_shape, b_shape) = SHAPES[name]
  rng = np.random.default_rng(seed)
  out_shape = a_shape[:-1] + b_shape[-1:]
  return [rng.normal(size=s).astype(np.float32)
          for s in (a_shape, b_shape, out_shape)]


def _jax_matmul_bf16(a, b):
  return (jax.vmap(j_mixed.matmul_bf16) if a.ndim == 3 else
          j_mixed.matmul_bf16)(a, b)


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_forward_matches_jax(name):
  a, b, _ = _inputs(name)
  got = t_mixed.matmul_bf16(torch.as_tensor(a), torch.as_tensor(b))
  assert got.dtype == torch.float32
  want = _jax_matmul_bf16(jnp.asarray(a), jnp.asarray(b))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **PARITY)
  np.testing.assert_allclose(got.numpy(), a @ b, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize('name', sorted(SHAPES))
def test_gradients_match_jax(name):
  a, b, w = _inputs(name)
  ta, tb = (torch.as_tensor(v).requires_grad_(True) for v in (a, b))
  (t_mixed.matmul_bf16(ta, tb) * torch.as_tensor(w)).sum().backward()
  want = jax.grad(
      lambda x, y: jnp.sum(_jax_matmul_bf16(x, y) * jnp.asarray(w)),
      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
  for got, ref, exact in zip((ta.grad, tb.grad), want,
                             (w @ np.swapaxes(b, -1, -2),
                              np.swapaxes(a, -1, -2) @ w)):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **PARITY)
    np.testing.assert_allclose(got.numpy(), exact, rtol=5e-2, atol=5e-2)


def test_products_are_exact_and_the_result_stays_fp32():
  a, b, _ = _inputs('plain')
  got = t_mixed.matmul_bf16(torch.as_tensor(a), torch.as_tensor(b)).numpy()
  a16, b16 = (torch.as_tensor(v).bfloat16().double().numpy() for v in (a, b))
  exact = a16 @ b16
  # fp32 sums of 24 exact products: a few ulp of the terms' magnitude.
  bound = 24 * np.finfo(np.float32).eps * (np.abs(a16) @ np.abs(b16))
  assert (np.abs(got - exact) <= bound).all()
  # Not rounded to bf16 afterwards.
  assert (got != torch.as_tensor(got).bfloat16().float().numpy()).mean() > 0.9


def test_exact_da_keeps_the_first_gradient_fp32():
  # K1 keeps a weight gradient with one column in fp32: da = g @ b^T on the
  # unrounded g and b; db is matmul_bf16's.
  a, b, w = _inputs('batched')
  grads = []
  for exact_da in (False, True):
    ta, tb = (torch.as_tensor(v).requires_grad_(True) for v in (a, b))
    out = t_mixed.matmul_bf16(ta, tb, exact_da=exact_da)
    (out * torch.as_tensor(w)).sum().backward()
    grads.append((out.detach(), ta.grad, tb.grad))
  (out0, da0, db0), (out1, da1, db1) = grads
  assert torch.equal(out0, out1) and torch.equal(db0, db1)
  assert torch.equal(da1, torch.as_tensor(w) @ torch.as_tensor(b).mT)
  assert not torch.equal(da0, da1)


@pytest.mark.parametrize('site', ['exact_out', 'exact_da', 'exact_db'])
def test_each_product_can_stay_fp32(site):
  # The row-major kernels keep the products whose result has a last
  # dimension of 1 in fp32 (`field.mlp`): an exact site takes the unrounded
  # operands and cotangent, the other two stay matmul_bf16's.
  a, b, w = _inputs('batched')
  results = []
  for kwargs in ({}, {site: True}):
    ta, tb = (torch.as_tensor(v).requires_grad_(True) for v in (a, b))
    out = t_mixed.matmul_bf16(ta, tb, **kwargs)
    (out * torch.as_tensor(w)).sum().backward()
    results.append((out.detach(), ta.grad, tb.grad))
  ta, tb, tw = (torch.as_tensor(v) for v in (a, b, w))
  exact = {'exact_out': torch.matmul(ta, tb), 'exact_da': tw @ tb.mT,
           'exact_db': ta.mT @ tw}
  for name, rounded, got in zip(('exact_out', 'exact_da', 'exact_db'),
                                *results):
    if name == site:
      assert torch.equal(got, exact[name]) and not torch.equal(got, rounded)
    else:
      assert torch.equal(got, rounded)
  assert torch.equal(
      t_mixed.matmul(ta, tb, 'bf16', **{site: True}),
      t_mixed.matmul_bf16(ta, tb, **{site: True}))


def test_highest_is_f32_and_unknown_precisions_raise():
  a, b, _ = _inputs('batched')
  ta, tb = torch.as_tensor(a), torch.as_tensor(b)
  want = torch.matmul(ta, tb)
  for precision in ('f32', 'highest'):
    assert torch.equal(t_mixed.matmul(ta, tb, precision), want)
  assert torch.equal(t_mixed.matmul(ta, tb, 'bf16'),
                     t_mixed.matmul_bf16(ta, tb))
  for precision in t_mixed.PRECISIONS:
    t_mixed.check_precision(precision)
  with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
    t_mixed.check_precision('fp16')


def test_fp32_matmuls_pins_and_restores_tf32():
  saved = torch.get_float32_matmul_precision()
  try:
    torch.backends.cuda.matmul.allow_tf32 = True
    with t_mixed.fp32_matmuls():
      assert not torch.backends.cuda.matmul.allow_tf32
      assert torch.get_float32_matmul_precision() == 'highest'
    assert torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision('medium')
    with pytest.raises(KeyError):
      with t_mixed.fp32_matmuls():
        raise KeyError('restored on the way out too')
    assert torch.get_float32_matmul_precision() == 'medium'
  finally:
    torch.set_float32_matmul_precision(saved)


def test_fp32_matmuls_restores_per_backend_settings():
  # A caller that set a backend's `fp32_precision` (after which PyTorch
  # refuses to read the global setting); in a process of its own, as the
  # setting cannot be undone for the process's other tests.
  code = '\n'.join([
      'import torch',
      'from bayesnf_torch.ops import mixed',
      'cuda, onednn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul',
      "cuda.fp32_precision, onednn.fp32_precision = 'tf32', 'bf16'",
      'with mixed.fp32_matmuls():',
      '  inside = (cuda.fp32_precision, onednn.fp32_precision)',
      '  torch.ones(2, 2) @ torch.ones(2, 2)',
      'print(inside, (cuda.fp32_precision, onednn.fp32_precision))',
  ])
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, check=True, timeout=120)
  assert out.stdout.split('\n')[-2] == (
      "('ieee', 'ieee') ('tf32', 'bf16')"), out.stdout + out.stderr
