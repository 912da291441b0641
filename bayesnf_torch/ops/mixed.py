"""Precision tiers of the fit's matrix products (counterpart of
`bayesnf_tpu/ops/mixed.py`).

Every fit takes `precision`, one of `PRECISIONS`:

- 'f32': true fp32 products, TF32 off.
- 'highest': the same products as 'f32', bit for bit. (The JAX package needs
  it to get true-fp32 dots on a TPU, whose default dot rounds its operands to
  bf16; the port's 'f32' already is true fp32.)
- 'bf16': each product takes its operands rounded to bf16 (round to nearest
  even), multiplies them exactly and sums in fp32; the result stays fp32.

`matmul_bf16` is the JAX package's `mixed.matmul_bf16`: forward a16 @ b16,
backward da = g16 @ b16^T and db = a16^T @ g16 on the rounded cotangent,
with the rounded operands kept for the backward; each of the three products
may instead stay fp32, where a kernel keeps it so. A product of two bf16
values is exact in fp32, so `a16.float() @ b16.float()` computes "exact
products, fp32 sums" on any device, provided the fp32 product itself is not
demoted: `fp32_matmuls` pins that for the fit.
"""

import contextlib

import torch

PRECISIONS = ('f32', 'bf16', 'highest')


def check_precision(precision) -> None:
  """Raises ValueError unless `precision` is one of `PRECISIONS`."""
  if precision not in PRECISIONS:
    raise ValueError(
        f'Unknown precision {precision!r}; expected one of {PRECISIONS}.')


@contextlib.contextmanager
def fp32_matmuls():
  """Runs fp32 matrix products in true fp32 (no TF32 or bf16 passes),
  whatever the caller set, and restores the caller's setting afterwards.

  A caller that set `torch.backends.cuda.matmul.allow_tf32` or
  `torch.set_float32_matmul_precision` gets it back through the latter. One
  that set a backend's `fp32_precision` (PyTorch then refuses to read the
  global setting) gets the CUDA and oneDNN matmul ones back."""
  try:
    before = torch.get_float32_matmul_precision()
  except RuntimeError:
    before = None
  if before is not None:
    torch.set_float32_matmul_precision('highest')
    try:
      yield
    finally:
      torch.set_float32_matmul_precision(before)
    return
  backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
  saved = [b.fp32_precision for b in backends]
  for b in backends:
    b.fp32_precision = 'ieee'
  try:
    yield
  finally:
    for b, p in zip(backends, saved):
      b.fp32_precision = p


def _exact_product(a16, b16):
  """a16 @ b16 of bf16 tensors: exact products, fp32 sums, fp32 result."""
  return torch.matmul(a16.float(), b16.float())


class _MatmulBf16(torch.autograd.Function):
  """a @ b (batched over leading axes), with each of its three products --
  the forward a @ b, the backward's da = g @ b^T and db = a^T @ g -- either
  on bf16-rounded operands (`round_*` True) or in fp32 on the unrounded
  operands and cotangent. The JAX kernels keep a product in fp32 when its
  result has a last dimension of 1, and the layouts put that 1 at different
  sites (`field.mlp_t` and `field.mlp`)."""

  @staticmethod
  def forward(ctx, a, b, round_out, round_da, round_db):
    a16, b16 = a.bfloat16(), b.bfloat16()  # round to nearest even
    ctx.sites = (round_da, round_db)
    ctx.save_for_backward(a16, b16, None if round_db else a,
                          None if round_da else b)
    return _exact_product(a16, b16) if round_out else torch.matmul(a, b)

  @staticmethod
  def backward(ctx, g):
    a16, b16, a, b = ctx.saved_tensors
    round_da, round_db = ctx.sites
    g16 = g.bfloat16()
    if round_da:
      da = _exact_product(g16, b16.transpose(-1, -2))
    else:
      da = torch.matmul(g, b.transpose(-1, -2))
    if round_db:
      db = _exact_product(a16.transpose(-1, -2), g16)
    else:
      db = torch.matmul(a.transpose(-1, -2), g)
    return da, db, None, None, None


def matmul_bf16(a: torch.Tensor, b: torch.Tensor, exact_da: bool = False,
                exact_out: bool = False, exact_db: bool = False
                ) -> torch.Tensor:
  """a @ b with bf16 operands and fp32 sums, forward and backward; a and b
  may carry the same leading (member) axes. Each `exact_*` keeps one
  product in fp32 instead: the forward (`exact_out`), da = g @ b^T
  (`exact_da`; K1 keeps its one-column weight gradient so) or
  db = a^T @ g (`exact_db`)."""
  return _MatmulBf16.apply(a, b, not exact_out, not exact_da, not exact_db)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = 'f32',
           exact_da: bool = False, exact_out: bool = False,
           exact_db: bool = False) -> torch.Tensor:
  """a @ b at `precision`: `torch.matmul` for 'f32' and 'highest',
  `matmul_bf16` (with its `exact_*` sites) for 'bf16'."""
  if precision == 'bf16':
    return matmul_bf16(a, b, exact_da, exact_out, exact_db)
  return torch.matmul(a, b)
