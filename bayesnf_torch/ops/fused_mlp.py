"""Fused ensemble field-MLP kernels (counterparts of the five Pallas kernels
of `bayesnf_tpu/ops/fused_mlp.py`).

The field MLP, per ensemble member e:

    h_0 = the encoded features                         (F per row)
    for l in 0..depth-1:
        z_l = s_l * (W_l^T (h_l / sqrt(fan_in)) + b_l)
        h_{l+1} = w * elu(z_l) + (1 - w) * tanh(z_l)
    pred = s_out * (W_out^T (h_depth / sqrt(width)) + b_out)[0]

with s_l = softplus(layer_scales_raw[l]) and w = sigmoid(activation_logit).

`fused_field_mlp_t` takes h_0 features-major, as (E, f_g, N) feature groups
(K2 forward, K3 backward), `fused_field_mlp` row-major, as (E, N, F) (K4a
forward, K4b backward). Both are differentiable: their backward kernels
recompute the forward and return the gradient of every input, as the JAX
package's custom VJPs do.

K1 computes, from the raw inputs, the encode, the same MLP, the negative
log-likelihood (NORMAL, NB or ZINB) summed over rows (or over the first
`n_valid` of them: a row shard's valid prefix), and its gradient with
respect to every learned input (see `fused_train`). Its data inputs are shared by every
member, or stored once per group of `rep` consecutive members (rep = 1: one
minibatch per member; rep = S: a VI member's minibatch feeds its S draws).

On CUDA tensors the entry points launch the hand-written CUDA kernels
(`csrc/fused_mlp_t.cu`: K2, K3, K4a and K4b; `csrc/fused_train.cu`: K1),
and on CPU
tensors they compute their plain PyTorch versions
(`fused_field_mlp_t_reference`, `fused_field_mlp_reference`,
`fused_train_reference`). They never fall back: on a CUDA tensor each
launches its kernel or raises, forward and backward alike.
"""

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import _build
from bayesnf_torch.ops import mixed
from bayesnf_torch.utils import profiling

_T_LIB_NAME = 'fused_mlp_t'
_TRAIN_LIB_NAME = 'fused_train'
MAX_DEPTH = 8  # kMaxLayers - 1 in the kernel sources.
MAX_MEMBERS = 65535  # gridDim.y.
# The row tile of the layer-wise kernels (kRowTile in
# csrc/field_layers.cuh): their chunks are whole tiles, at most gridDim.y of
# them (their GEMMs' grid).
TRAIN_ROW_TILE = 128
MAX_TRAIN_CHUNK_TILES = 65535
MAX_INPUTS = 8  # kMaxInputs in csrc/fused_train.cu.
MAX_PAIRS = 32  # kMaxPairs.
# K1's per-tile scalar partial sums: 2 + inputs + groups, and for NB and
# ZINB two more (`num_partials`); its finalize sums one per thread of a warp.
MAX_PARTIALS = 32
# The kernel's likelihood codes (`Lik` in csrc/fused_train.cu).
LIKELIHOOD_CODES = {'NORMAL': 0, 'NB': 1, 'ZINB': 2}
# Its precision codes: 'highest' runs the fp32 kernel (see `ops/mixed.py`).
PRECISION_CODES = {'f32': 0, 'highest': 0, 'bf16': 1}
# The field MLP's layout codes in `csrc/fused_mlp_t.cu`: h0 (E, F, N)
# features-major (K2, K3), or (E, N, F) row-major (K4a, K4b).
LAYOUT_CODES = {'features': 0, 'rows': 1}
# Global scratch one `fused_train` call, or one call of the field MLP's
# kernels, may hold; rows are processed in chunks that fit it.
TRAIN_SCRATCH_BYTES = 2 << 30
# While a profiler records (`utils/profiling.py`), K2's inner row chunks
# under that budget, summed over its calls.
K2_ROW_CHUNKS = 'bnf.k2.row_chunks'


def fused_field_mlp_t_reference(
    depth, h0_groups, weights, biases, scales_raw, logit, precision='f32'
) -> torch.Tensor:
  """Plain PyTorch K2 (`field.mlp_t`): one `torch.matmul` per layer. Under
  'bf16' it rounds where the features-major kernels round
  (`k1_sites=True`), so autograd through it is the plain K3.

  Args:
    depth: hidden layers.
    h0_groups: sequence of (E, f_g, N) feature-group tensors.
    weights: depth + 1 tensors (E, fan_in, fan_out); the last has fan_out 1.
    biases: depth + 1 tensors (E, fan_out).
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.
    precision: 'f32' | 'highest' | 'bf16'.

  Returns:
    (E, N) predictions.
  """
  return field_lib.mlp_t(depth, h0_groups, weights, biases, scales_raw, logit,
                         precision, k1_sites=True)


def fused_field_mlp_reference(
    depth, h0, weights, biases, scales_raw, logit, precision='f32'
) -> torch.Tensor:
  """Plain PyTorch K4a (`field.mlp`), row-major: (E, N, F) -> (E, N); its
  'bf16' sites are the row-major kernels' (the output layer's h @ W_out and
  weight gradient stay fp32)."""
  return field_lib.mlp(depth, h0, weights, biases, scales_raw, logit,
                       precision)


def _vjp_reference(forward, inputs, g):
  """Autograd of `forward(*inputs)` against the cotangent g, in true fp32;
  an input the forward does not read (the logit at depth 0) gets zeros."""
  leaves = [t.detach().requires_grad_(True) for t in inputs]
  with torch.enable_grad(), mixed.fp32_matmuls():
    return torch.autograd.grad(forward(*leaves), leaves, g, allow_unused=True,
                               materialize_grads=True)


def _split_grads(grads, num_groups, depth):
  num_w = depth + 1
  return (tuple(grads[:num_groups]),
          tuple(grads[num_groups : num_groups + num_w]),
          tuple(grads[num_groups + num_w : num_groups + 2 * num_w]),
          grads[-2], grads[-1])


def fused_field_mlp_t_vjp_reference(
    depth, h0_groups, weights, biases, scales_raw, logit, g, precision='f32'
):
  """Plain K3: the JAX package's `_forward_t_bwd` output, by autograd
  through :func:`fused_field_mlp_t_reference`.

  Returns:
    (dh0 per group, dweights, dbiases, dscales_raw, dlogit), each shaped
    like its input.
  """
  num_g, num_w = len(h0_groups), depth + 1

  def forward(*t):
    return fused_field_mlp_t_reference(
        depth, t[:num_g], t[num_g : num_g + num_w],
        t[num_g + num_w : num_g + 2 * num_w], t[-2], t[-1], precision)

  return _split_grads(_vjp_reference(
      forward, (*h0_groups, *weights, *biases, scales_raw, logit), g),
                      num_g, depth)


def fused_field_mlp_vjp_reference(
    depth, h0, weights, biases, scales_raw, logit, g, precision='f32'
):
  """Plain K4b: the JAX package's `_forward_bwd` output, by autograd through
  :func:`fused_field_mlp_reference`.

  Returns:
    (dh0, dweights, dbiases, dscales_raw, dlogit), each shaped like its
    input.
  """
  num_w = depth + 1

  def forward(h, *t):
    return fused_field_mlp_reference(depth, h, t[:num_w], t[num_w:2 * num_w],
                                     t[-2], t[-1], precision)

  dh0, *rest = _split_grads(_vjp_reference(
      forward, (h0, *weights, *biases, scales_raw, logit), g), 1, depth)
  return (dh0[0], *rest)


def _declare_common(lib):
  lib.bnf_cuda_error_string.argtypes = [ctypes.c_int]
  lib.bnf_cuda_error_string.restype = ctypes.c_char_p


@functools.cache
def _t_lib() -> ctypes.CDLL:
  lib = _build.load_library(_T_LIB_NAME)
  ptr, ptrs, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
  rsqrts = ctypes.POINTER(ctypes.c_float)
  # layout, precision, depth, members, features, width, rows
  sizes = [i32] * 7
  lib.bnf_fused_mlp_t_fwd.argtypes = [
      ptr, ptrs, ptrs,  # h0, weights, biases
      ptr, ptr, ptr, ptr,  # scales_raw, logit, out, scratch
      rsqrts, *sizes, i32, ptr,  # chunk_rows, stream
  ]
  lib.bnf_fused_mlp_t_fwd.restype = ctypes.c_int
  lib.bnf_fused_mlp_t_bwd.argtypes = [
      ptr, ptr, ptrs, ptrs,  # h0, g, weights, biases
      ptr, ptr, ptr,  # scales_raw, logit, dh0
      ptrs, ptrs, ptr, ptr,  # dweights, dbiases, dscales, dlogit
      ptr,  # scratch
      rsqrts, *sizes, i32, ptr,  # chunk_rows, stream
  ]
  lib.bnf_fused_mlp_t_bwd.restype = ctypes.c_int
  lib.bnf_fused_mlp_t_scratch_bytes.argtypes = [i32] * 8
  lib.bnf_fused_mlp_t_scratch_bytes.restype = ctypes.c_size_t
  _declare_common(lib)
  return lib


def check_forward_shape(depth):
  """Raises ValueError for a depth the field-MLP kernels do not take (above
  MAX_DEPTH). They take any width."""
  if not 0 <= depth <= MAX_DEPTH:
    raise ValueError(f'depth must be in [0, {MAX_DEPTH}], got {depth}.')


def _dims(h0, layout):
  """(members E, features F, rows N) of h0 in `layout`."""
  if layout == 'features':
    return tuple(h0.shape)
  e, n, f = h0.shape
  return e, f, n


def _check_inputs(depth, h0, weights, biases, scales_raw, logit,
                  layout='features'):
  """Raises ValueError on anything the kernels do not take.

  Returns:
    the width (at depth 0, F).
  """
  e, f, _ = _dims(h0, layout)
  check_forward_shape(depth)
  if len(weights) != depth + 1 or len(biases) != depth + 1:
    raise ValueError(
        f'Expected {depth + 1} weights and biases, got {len(weights)} and '
        f'{len(biases)}.'
    )
  if not 1 <= e <= MAX_MEMBERS:
    raise ValueError(f'members must be in [1, {MAX_MEMBERS}], got {e}.')
  width = weights[0].shape[-1] if depth else f
  fan_ins = [f] + [width] * depth
  fan_outs = [width] * depth + [1]
  expected = [
      *[(e, fi, fo) for fi, fo in zip(fan_ins, fan_outs)],
      *[(e, fo) for fo in fan_outs],
      (e, depth + 1),
      (e,),
  ]
  for t, shape in zip((*weights, *biases, scales_raw, logit), expected):
    if tuple(t.shape) != shape:
      raise ValueError(f'Expected a tensor of shape {shape}, got {t.shape}.')
  for t in (h0, *weights, *biases, scales_raw, logit):
    if t.dtype != torch.float32:
      raise ValueError(f'Expected float32 tensors, got {t.dtype}.')
    if t.device != h0.device:
      raise ValueError(
          f'All tensors must be on {h0.device}; got one on {t.device}.'
      )
    if not t.is_contiguous():
      raise ValueError('All tensors must be contiguous.')
  return width


def _ptrs(ts):
  return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _rsqrts(fan_ins):
  # 1/sqrt(fan_in) in double, rounded to float32 (as the JAX package does).
  return (ctypes.c_float * len(fan_ins))(
      *[1.0 / math.sqrt(fi) for fi in fan_ins])


def _raise_on(err, lib, what):
  if err != 0:
    raise RuntimeError(
        f'{what} kernel launch failed: CUDA error {err} '
        f'({lib.bnf_cuda_error_string(err).decode()}).'
    )


def _entry(layout):
  return fused_field_mlp_t if layout == 'features' else fused_field_mlp


def _chunk_rows(scratch_bytes, n):
  """Rows per chunk of a layer-wise call (K1, K2-K4b): as many whole
  TRAIN_ROW_TILE-row tiles as TRAIN_SCRATCH_BYTES holds beside what the call
  holds whatever its rows (under 'bf16' the weights' bf16 copies), at most
  MAX_TRAIN_CHUNK_TILES of them, and no more than n's own tiles.
  `scratch_bytes(chunk_rows, n_rows)` is the library's formula; it does not
  depend on n beyond n's own tiles, so rows past a valid count move no
  chunk boundary."""
  tile = TRAIN_ROW_TILE
  fixed = scratch_bytes(0, 0)
  per_row = scratch_bytes(1, 0) - fixed
  tiles = min(max(1, (TRAIN_SCRATCH_BYTES - fixed) // per_row // tile),
              MAX_TRAIN_CHUNK_TILES)
  return min(tiles * tile, -(-n // tile) * tile)


def _t_scratch(lib, h0, layout, width, depth, code, backward):
  """(chunk rows, scratch tensor) of a forward (`backward` 0) or backward
  (1) call of the field MLP; the plan does not depend on the layout."""
  e, f, n = _dims(h0, layout)

  def scratch_bytes(rows, total):
    return lib.bnf_fused_mlp_t_scratch_bytes(e, f, width, depth, rows, total,
                                             code, backward)

  chunk_rows = _chunk_rows(scratch_bytes, n)
  scratch = torch.empty(-(-scratch_bytes(chunk_rows, n) // 4),
                        dtype=torch.float32, device=h0.device)
  return chunk_rows, scratch


def _launch_k2(lib, stream, layout, depth, precision, width, h0, weights,
               biases, scales_raw, logit):
  """One forward call of `lib` on `stream` (K2 features-major, K4a
  row-major), layer-wise over chunks of whole 128-row tiles; `width` is
  what `_check_inputs` returned."""
  e, f, n = _dims(h0, layout)
  code = PRECISION_CODES[precision]
  chunk_rows, scratch = _t_scratch(lib, h0, layout, width, depth, code, 0)
  if layout == 'features' and profiling.recording():
    profiling.count(K2_ROW_CHUNKS, -(-n // chunk_rows))
  out = torch.empty((e, n), dtype=torch.float32, device=h0.device)
  err = lib.bnf_fused_mlp_t_fwd(
      h0.data_ptr(), _ptrs(weights), _ptrs(biases), scales_raw.data_ptr(),
      logit.data_ptr(), out.data_ptr(), scratch.data_ptr(),
      _rsqrts([f] + [width] * depth), LAYOUT_CODES[layout], code, depth, e,
      f, width, n, chunk_rows, stream)
  _raise_on(err, lib, _entry(layout).__name__)
  return out


def _launch_k3(lib, stream, layout, depth, precision, width, h0, weights,
               biases, scales_raw, logit, g):
  """One backward call of `lib` on `stream` (K3 features-major, K4b
  row-major), as `_launch_k2`.

  Returns:
    (dh0 laid out as h0, dweights, dbiases, dscales_raw, dlogit).
  """
  e, f, n = _dims(h0, layout)
  code = PRECISION_CODES[precision]
  chunk_rows, scratch = _t_scratch(lib, h0, layout, width, depth, code, 1)
  dh0, dws, dbs, dscales, dlogit = outs = _empty_grads(h0, weights, biases,
                                                       scales_raw, logit)
  err = lib.bnf_fused_mlp_t_bwd(
      h0.data_ptr(), g.data_ptr(), _ptrs(weights), _ptrs(biases),
      scales_raw.data_ptr(), logit.data_ptr(), dh0.data_ptr(), _ptrs(dws),
      _ptrs(dbs), dscales.data_ptr(), dlogit.data_ptr(), scratch.data_ptr(),
      _rsqrts([f] + [width] * depth), LAYOUT_CODES[layout], code, depth, e,
      f, width, n, chunk_rows, stream)
  _raise_on(err, lib, f'{_entry(layout).__name__} backward')
  return outs


def _empty_grads(h0, weights, biases, scales_raw, logit):
  return (torch.empty_like(h0), tuple(torch.empty_like(w) for w in weights),
          tuple(torch.empty_like(b) for b in biases),
          torch.empty_like(scales_raw), torch.empty_like(logit))


def _launch_forward(layout, depth, precision, h0, weights, biases,
                    scales_raw, logit):
  """One K2 (features-major) or K4a (row-major) call on the current stream."""
  width = _check_inputs(depth, h0, weights, biases, scales_raw, logit, layout)
  e, _, n = _dims(h0, layout)
  if n == 0:
    return torch.empty((e, 0), dtype=torch.float32, device=h0.device)
  with torch.cuda.device(h0.device):
    out = _launch_k2(_t_lib(), torch.cuda.current_stream().cuda_stream,
                     layout, depth, precision, width, h0, weights, biases,
                     scales_raw, logit)
  _entry(layout).launches += 1
  return out


def _launch_backward(layout, depth, precision, h0, weights, biases,
                     scales_raw, logit, g):
  """One K3 (features-major) or K4b (row-major) call on the current stream.

  Returns:
    (dh0 laid out as h0, dweights, dbiases, dscales_raw, dlogit).
  """
  width = _check_inputs(depth, h0, weights, biases, scales_raw, logit, layout)
  e, _, n = _dims(h0, layout)
  if tuple(g.shape) != (e, n) or g.dtype != torch.float32 or (
      g.device != h0.device):
    raise ValueError(
        f'The cotangent must be a float32 ({e}, {n}) tensor on {h0.device}; '
        f'got {g.dtype} {tuple(g.shape)} on {g.device}.')
  if n == 0:
    outs = _empty_grads(h0, weights, biases, scales_raw, logit)
    for t in (outs[0], *outs[1], *outs[2], *outs[3:]):
      t.zero_()
    return outs
  with torch.cuda.device(h0.device):
    outs = _launch_k3(_t_lib(), torch.cuda.current_stream().cuda_stream,
                      layout, depth, precision, width, h0, weights, biases,
                      scales_raw, logit, g)
  _entry(layout).bwd_launches += 1
  return outs


class _FusedFieldMlp(torch.autograd.Function):
  """The field MLP on CUDA tensors: the forward kernel, and the backward
  kernel for the gradient of every input. It saves only its inputs (the JAX
  package's residuals) and recomputes the forward in the backward."""

  @staticmethod
  def forward(ctx, layout, depth, precision, num_groups, *tensors):
    ctx.args = (layout, depth, precision, num_groups)
    ctx.save_for_backward(*tensors)
    return _launch_forward(layout, depth, precision,
                           _join(layout, tensors[:num_groups]),
                           *_unpack(depth, tensors[num_groups:]))

  @staticmethod
  @once_differentiable
  def backward(ctx, g):
    layout, depth, precision, num_groups = ctx.args
    tensors = ctx.saved_tensors
    dh0, dws, dbs, dscales, dlogit = _backward(
        layout, depth, precision, tensors[:num_groups],
        *_unpack(depth, tensors[num_groups:]), g.contiguous())
    return (None, None, None, None, *dh0, *dws, *dbs, dscales, dlogit)


def _backward(layout, depth, precision, h0_groups, weights, biases,
              scales_raw, logit, g):
  """K3 or K4b on CUDA tensors; dh0 as a tuple of the groups' gradients."""
  dh0, *rest = _launch_backward(layout, depth, precision,
                                _join(layout, h0_groups), weights, biases,
                                scales_raw, logit, g)
  if layout == 'features':
    return (dh0.split([t.shape[1] for t in h0_groups], dim=1), *rest)
  return ((dh0,), *rest)


def _join(layout, h0_groups):
  """The kernels read one h0 buffer: several features-major groups are
  joined here, one extra copy of the encoded inputs (E * F * N floats),
  small beside the kernels' E * N * width^2 FMAs."""
  if len(h0_groups) == 1:
    return h0_groups[0]
  return torch.cat(tuple(h0_groups), 1 if layout == 'features' else 2)


def _unpack(depth, params):
  """(weights, biases, scales_raw, logit) of the flat parameter tensors."""
  num_w = depth + 1
  return params[:num_w], params[num_w : 2 * num_w], params[-2], params[-1]


def _on_cuda(layout, precision, tensors):
  """False for CPU tensors (the plain versions' case), True for CUDA ones.

  Raises:
    ValueError: on an unknown precision, or tensors on another device.
  """
  mixed.check_precision(precision)
  if all(t.device.type == 'cpu' for t in tensors):
    return False
  if tensors[0].device.type != 'cuda':
    raise ValueError(
        f'{_entry(layout).__name__} runs on CUDA or CPU tensors, got '
        f'{tensors[0].device}.'
    )
  return True


def fused_field_mlp_t(
    depth, h0_groups, weights, biases, scales_raw, logit, precision='f32'
) -> torch.Tensor:
  """Fused field MLP, features-major: (E, f_g, N) feature groups -> (E, N)
  predictions; differentiable.

  Takes the JAX package's layout and arguments (without its TPU-only
  `tile`). On CPU tensors it returns :func:`fused_field_mlp_t_reference`
  (which autograd differentiates). On CUDA tensors it launches K2 on the
  current stream (counted in `fused_field_mlp_t.launches`), and autograd
  through the result launches K3 (counted in
  `fused_field_mlp_t.bwd_launches`), which returns the gradient of every
  group, weight, bias, `scales_raw` and `logit` (the JAX package's
  `_forward_t_bwd`); without a graph (as in predict) no K3 runs. The call
  is the `bnf.k2` span (`utils/profiling.py`), and K2 counts its inner row
  chunks in `K2_ROW_CHUNKS` while a profiler records.

  Args:
    depth: hidden layers.
    h0_groups: sequence of (E, f_g, N) feature-group tensors.
    weights: depth + 1 tensors (E, fan_in, fan_out); the last has fan_out 1.
    biases: depth + 1 tensors (E, fan_out).
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.
    precision: 'f32' | 'highest' (the same fp32 kernels) | 'bf16' (bf16
      operands, exact products, fp32 sums: every product but the output
      layer's weight gradient, as the TPU kernels).

  On CUDA, K2 and K3 run layer-wise (`csrc/fused_mlp_t.cu`): over chunks
  of whole 128-row tiles sized under `TRAIN_SCRATCH_BYTES`, one GEMM per
  layer and direction (SIMT fp32 under 'f32', tensor cores under 'bf16'),
  so any width fits. `fused_field_mlp` runs the same kernels on the same
  plan.

  Raises:
    ValueError: on an unknown precision, or on CUDA on shapes, dtypes,
      devices or layouts the kernels do not take.
    RuntimeError: if a kernel fails to build or to launch, or a tensor map
      of the 'bf16' products is refused.
  """
  with profiling.span('bnf.k2'):
    tensors = (*h0_groups, *weights, *biases, scales_raw, logit)
    if not _on_cuda('features', precision, tensors):
      return fused_field_mlp_t_reference(depth, h0_groups, weights, biases,
                                         scales_raw, logit, precision)
    return _FusedFieldMlp.apply('features', depth, precision,
                                len(h0_groups), *tensors)


fused_field_mlp_t.launches = 0
fused_field_mlp_t.bwd_launches = 0


def fused_field_mlp_t_vjp(
    depth, h0_groups, weights, biases, scales_raw, logit, g, precision='f32'
):
  """The backward of :func:`fused_field_mlp_t` for the cotangent g (E, N)
  alone (the JAX package's `_forward_t_bwd`): on CUDA tensors one K3 call
  (counted in `fused_field_mlp_t.bwd_launches`), on CPU tensors
  :func:`fused_field_mlp_t_vjp_reference`.

  Returns:
    (dh0 per group, dweights, dbiases, dscales_raw, dlogit).
  """
  tensors = (*h0_groups, *weights, *biases, scales_raw, logit, g)
  if not _on_cuda('features', precision, tensors):
    return fused_field_mlp_t_vjp_reference(depth, h0_groups, weights, biases,
                                           scales_raw, logit, g, precision)
  return _backward('features', depth, precision, h0_groups, weights, biases,
                   scales_raw, logit, g.contiguous())


def fused_field_mlp(
    depth, h0, weights, biases, scales_raw, logit, precision='f32'
) -> torch.Tensor:
  """Fused field MLP, row-major: (E, N, F) encoded features -> (E, N)
  predictions; differentiable (the JAX package's `fused_field_mlp`, without
  its TPU-only `tile`).

  On CPU tensors it returns :func:`fused_field_mlp_reference`; on CUDA
  tensors it launches K4a (`fused_field_mlp.launches`), and autograd through
  the result launches K4b (`fused_field_mlp.bwd_launches`), which returns
  dh0 (E, N, F) and the gradient of every parameter. K4a and K4b are K2's
  and K3's layer-wise kernels (`csrc/fused_mlp_t.cu`) reading h0 and
  writing dh0 row-major, so any width fits. Under 'bf16' the products
  round where the row-major TPU kernels round: not a product whose result
  has one column (the output layer's h @ W_out and its weight gradient; at
  width 1 the hidden forwards and the W dv products of layers >= 1; with
  F = 1 the first layer's d h0).

  Raises:
    ValueError: as :func:`fused_field_mlp_t`.
    RuntimeError: if a kernel fails to build or to launch, or a tensor map
      of the 'bf16' products is refused.
  """
  tensors = (h0, *weights, *biases, scales_raw, logit)
  if not _on_cuda('rows', precision, tensors):
    return fused_field_mlp_reference(depth, h0, weights, biases, scales_raw,
                                     logit, precision)
  return _FusedFieldMlp.apply('rows', depth, precision, 1, *tensors)


fused_field_mlp.launches = 0
fused_field_mlp.bwd_launches = 0


def fused_field_mlp_vjp(
    depth, h0, weights, biases, scales_raw, logit, g, precision='f32'
):
  """The backward of :func:`fused_field_mlp` for the cotangent g (E, N)
  alone (the JAX package's `_forward_bwd`): on CUDA tensors one K4b call
  (`fused_field_mlp.bwd_launches`), on CPU tensors
  :func:`fused_field_mlp_vjp_reference`.

  Returns:
    (dh0, dweights, dbiases, dscales_raw, dlogit).
  """
  tensors = (h0, *weights, *biases, scales_raw, logit, g)
  if not _on_cuda('rows', precision, tensors):
    return fused_field_mlp_vjp_reference(depth, h0, weights, biases,
                                         scales_raw, logit, g, precision)
  (dh0,), *rest = _backward('rows', depth, precision, (h0,), weights, biases,
                            scales_raw, logit, g.contiguous())
  return (dh0, *rest)


# ---------------------------------------------------------------------------
# K1: the fused training objective (NORMAL, NB, ZINB; shared, per-member or
# grouped inputs).
# ---------------------------------------------------------------------------


def _check_call(distribution, precision, n_valid, n):
  """Raises ValueError for an unknown likelihood or precision, or a
  valid-row count outside [0, n]."""
  if distribution not in LIKELIHOOD_CODES:
    raise ValueError(
        f'fused_train: unknown likelihood {distribution!r}; expected one of '
        f'{sorted(LIKELIHOOD_CODES)}.'
    )
  mixed.check_precision(precision)
  if n_valid is not None and not 0 <= n_valid <= n:
    raise ValueError(
        f'fused_train: n_valid must be in [0, {n}] (the row count), got '
        f'{n_valid}.'
    )


def num_partials(num_inputs, num_groups, distribution) -> int:
  """Per-tile scalar partial sums of a K1 call: the NORMAL ones, and for NB
  and ZINB the sums behind the shape and zero-inflation gradients (the
  layers' sums of dz z and dh dact/dw are kept apart, per column block)."""
  return 2 + num_inputs + num_groups + (distribution != 'NORMAL') * 2


def _feature_layout(fourier_degrees, interactions, num_inputs, num_seasonal):
  """(encoded features F, feature groups G) of the encode."""
  degrees = [int(d) for d in fourier_degrees if d > 0]
  f = num_inputs + 2 * sum(degrees) + num_seasonal + len(interactions)
  g = 1 + len(degrees) + (num_seasonal > 0) + (len(interactions) > 0)
  return f, g


def fused_train_reference(
    distribution, depth, lik_scale, input_scales, fourier_degrees,
    interactions, x_t, seasonal_t, weights, biases, lsa, fs_raw, scales_raw,
    logit, obs_raw, y, precision='f32', n_valid=None,
):
  """Plain PyTorch K1: autograd through `field.encode_raw_t`, `field.mlp_t`
  and `likelihoods.log_likelihood`. Same arguments and outputs as
  :func:`fused_train`; grouped inputs are read per group through
  `field.grouped` views, never copied per member.

  Its count-model math is the exact one (`torch.lgamma`, log-softplus
  clamped at -20), as the JAX package's autodiff oracle; the kernel follows
  the TPU kernel (Stirling series, clamp at -15). The two differ by up to
  ~3e-4 relative.

  Under 'bf16' it rounds where K1 rounds (`field.mlp_t(k1_sites=True)`):
  every product but the output layer's weight gradient, which stays fp32.
  Its fp32 products run in true fp32 (`mixed.fp32_matmuls`).

  With `n_valid` it computes on the first `n_valid` rows only, so whatever
  the rows past them hold (NaN included) never enters a result."""
  _check_call(distribution, precision, n_valid, x_t.shape[-1])
  if n_valid is not None:
    x_t, seasonal_t, y = (t[..., :n_valid] for t in (x_t, seasonal_t, y))
  num_w = depth + 1
  leaves = [
      t.detach().requires_grad_(True)
      for t in (lsa, fs_raw, *weights, *biases, scales_raw, logit, obs_raw)
  ]
  ws, bs = leaves[2 : 2 + num_w], leaves[2 + num_w : 2 + 2 * num_w]
  with torch.enable_grad(), mixed.fp32_matmuls():
    groups = field_lib.encode_raw_t(
        input_scales, fourier_degrees, interactions, leaves[0], leaves[1],
        x_t, seasonal_t,
    )
    pred = field_lib.mlp_t(depth, groups, ws, bs, *leaves[-3:-1],
                           precision=precision, k1_sites=True)
    # The observation scalars as the three leading parameter leaves.
    losses = -lik_scale * likelihoods.log_likelihood(
        likelihoods.LikelihoodDist(distribution), leaves[-1].unbind(-1),
        pred, y)
    # At depth 0 the activation logit is unused, and each likelihood leaves
    # out some observation scalars: their gradients are zero.
    grads = torch.autograd.grad(
        losses.sum(), leaves, allow_unused=True, materialize_grads=True)
  return (
      losses.detach(), grads[0], grads[1], tuple(grads[2 : 2 + num_w]),
      tuple(grads[2 + num_w : 2 + 2 * num_w]), *grads[-3:],
  )


@functools.cache
def _train_lib() -> ctypes.CDLL:
  lib = _build.load_library(_TRAIN_LIB_NAME)
  ptr, ptrs, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
  lib.bnf_fused_train.argtypes = [
      ptr, ptr, ptr,  # x, seasonal, y
      ptrs, ptrs,  # weights, biases
      ptr, ptr, ptr, ptr, ptr,  # lsa_eff, fs_raw, scales_raw, logit, obs_raw
      ptr, ptr, ptr,  # losses, dlsa, dfs
      ptrs, ptrs,  # dweights, dbiases
      ptr, ptr, ptr,  # dscales, dlogit, dobs
      ptr,  # scratch
      ctypes.POINTER(ctypes.c_float),  # rsqrts
      ctypes.POINTER(i32), ctypes.POINTER(i32),  # fourier degrees, pairs
      # x, seasonal and y: group stride (floats) and members per group.
      ctypes.c_size_t, i32, ctypes.c_size_t, i32, ctypes.c_size_t, i32,
      ctypes.c_float,  # lik_scale
      i32,  # likelihood code
      i32,  # precision code
      i32, i32, i32, i32, i32, i32,  # depth, members, inputs, seasonal, pairs, width
      i32, i32, i32,  # n_rows, n_valid, chunk_rows
      ptr,  # stream
  ]
  lib.bnf_fused_train.restype = ctypes.c_int
  lib.bnf_fused_train_scratch_bytes.argtypes = [i32] * 10
  lib.bnf_fused_train_scratch_bytes.restype = ctypes.c_size_t
  lib.bnf_tc_gemm.argtypes = [ptr, ptr, ptr] + [i32] * 7 + [ptr]
  lib.bnf_tc_gemm.restype = ctypes.c_int
  _declare_common(lib)
  return lib


def input_groups(t, members, ndim, name):
  """(members per group, floats between groups) of a K1 data input: (1, 0)
  for a row set shared by every member, (E / G, one set's size) for G
  stored sets.

  Raises:
    ValueError: on another rank, or a group count that does not divide the
      member count (as the TPU kernel's index maps require).
  """
  if t.ndim == ndim:
    return 1, 0
  if t.ndim != ndim + 1:
    raise ValueError(
        f'fused_train: {name} must have {ndim} or {ndim + 1} dims, got '
        f'shape {tuple(t.shape)}.'
    )
  g = t.shape[0]
  if g < 1 or members % g:
    raise ValueError(
        f'fused_train: per-member {name} leading dim {g} must divide the '
        f'member count {members}.'
    )
  return members // g, t[0].numel()


def _input_layout(members, x_t, seasonal_t, y):
  """`input_groups` of x_t, seasonal_t and y, in the kernel's order."""
  return [input_groups(t, members, ndim, name) for t, ndim, name in (
      (x_t, 2, 'x_t'), (seasonal_t, 2, 'seasonal_t'), (y, 1, 'y'))]


def check_train_shape(distribution, depth, width, fourier_degrees,
                      interactions, num_seasonal):
  """Raises ValueError for a model K1 does not take under `distribution`:
  depth above MAX_DEPTH, other than 1 to MAX_INPUTS inputs (one Fourier
  degree each), more than MAX_PAIRS interaction pairs or a pair of unknown
  inputs, or more per-tile partial sums than MAX_PARTIALS. Any width fits:
  K1's tiles do not depend on it.

  Returns:
    (width, encoded features F, feature groups G); at depth 0 the width is F.
  """
  d = len(fourier_degrees)
  if not 0 <= depth <= MAX_DEPTH:
    raise ValueError(f'depth must be in [0, {MAX_DEPTH}], got {depth}.')
  if not 1 <= d <= MAX_INPUTS:
    raise ValueError(
        f'Expected 1 to {MAX_INPUTS} inputs with one input scale and one '
        f'Fourier degree each; got {d} degrees.'
    )
  if len(interactions) > MAX_PAIRS or any(
      not (0 <= a < d and 0 <= b < d) for a, b in interactions):
    raise ValueError(
        f'Expected at most {MAX_PAIRS} interaction pairs of input indices '
        f'below {d}, got {interactions}.'
    )
  f, g = _feature_layout(fourier_degrees, interactions, d, num_seasonal)
  if num_partials(d, g, distribution) > MAX_PARTIALS:
    raise ValueError(
        f'{d} inputs and {g} feature groups exceed the '
        f"kernel's {MAX_PARTIALS} per-tile partial sums under the "
        f'{distribution} likelihood.'
    )
  return (width if depth else f), f, g


def _check_train_inputs(
    depth, input_scales, fourier_degrees, interactions, x_t, seasonal_t,
    weights, biases, lsa, fs_raw, scales_raw, logit, obs_raw, y,
    distribution,
):
  """Raises ValueError on anything the K1 kernel does not take.

  Returns:
    (width, encoded features F, feature groups G).
  """
  d, n = x_t.shape[-2:]
  e = weights[0].shape[0] if weights else 0
  if len(weights) != depth + 1 or len(biases) != depth + 1:
    raise ValueError(
        f'Expected {depth + 1} weights and biases, got {len(weights)} and '
        f'{len(biases)}.'
    )
  if not 1 <= e <= MAX_MEMBERS:
    raise ValueError(f'members must be in [1, {MAX_MEMBERS}], got {e}.')
  if len(input_scales) != d or len(fourier_degrees) != d:
    raise ValueError(
        f'Expected one input scale and one Fourier degree for each of the '
        f'{d} inputs of x_t; got {len(input_scales)} scales and '
        f'{len(fourier_degrees)} degrees.'
    )
  if n < 1:
    raise ValueError('fused_train needs at least one row.')
  _input_layout(e, x_t, seasonal_t, y)
  width, f, g = check_train_shape(
      distribution, depth, weights[0].shape[-1], fourier_degrees,
      interactions, seasonal_t.shape[-2])
  fan_ins = [f] + [width] * depth
  fan_outs = [width] * depth + [1]
  expected = [
      (seasonal_t, seasonal_t.shape[:-1] + (n,)),
      (y, y.shape[:-1] + (n,)),
      *[(w, (e, fi, fo)) for w, fi, fo in zip(weights, fan_ins, fan_outs)],
      *[(b, (e, fo)) for b, fo in zip(biases, fan_outs)],
      (lsa, (e, d)),
      (fs_raw, (e, g)),
      (scales_raw, (e, depth + 1)),
      (logit, (e,)),
      (obs_raw, (e, 3)),
  ]
  for t, shape in expected:
    if tuple(t.shape) != shape:
      raise ValueError(f'Expected a tensor of shape {shape}, got {t.shape}.')
  for t in (x_t, *(t for t, _ in expected)):
    if t.dtype != torch.float32:
      raise ValueError(f'Expected float32 tensors, got {t.dtype}.')
    if t.device != x_t.device:
      raise ValueError(
          f'All tensors must be on {x_t.device}; got one on {t.device}.'
      )
    if not t.is_contiguous():
      raise ValueError('All tensors must be contiguous.')
  return width, f, g


def _launch_fused_train(
    lib, stream, dims, depth, lik_scale, input_scales, fourier_degrees,
    interactions, x_t, seasonal_t, weights, biases, lsa, fs_raw, scales_raw,
    logit, obs_raw, y, distribution, precision='f32', n_valid=None,
):
  """Allocates the outputs and the scratch, and runs one K1 call of `lib` on
  `stream`; `dims` is what `_check_train_inputs` returned for these inputs.
  Rows at index `n_valid` (None: n) and past it count for nothing."""
  width, f, g = dims
  d, n = x_t.shape[-2:]
  e = weights[0].shape[0]
  s2 = seasonal_t.shape[-2]
  layout = _input_layout(e, x_t, seasonal_t, y)
  dev = x_t.device
  likelihood = LIKELIHOOD_CODES[distribution]
  code = PRECISION_CODES[precision]

  def scratch_bytes(rows, total):
    # Under 'bf16' a row also holds its bf16 twins.
    return lib.bnf_fused_train_scratch_bytes(e, f, width, depth, d, g, rows,
                                             total, likelihood, code)

  chunk_rows = _chunk_rows(scratch_bytes, n)
  scratch = torch.empty(-(-scratch_bytes(chunk_rows, n) // 4),
                        dtype=torch.float32, device=dev)
  # The input scales fold into the learned log scale (as the TPU kernel
  # does): x / (s * e^lsa) = x * e^-(lsa + log s).
  lsa_eff = lsa + torch.log(
      torch.tensor(tuple(input_scales), dtype=torch.float32, device=dev))
  out = dict(
      losses=torch.empty((e,), dtype=torch.float32, device=dev),
      dlsa=torch.empty((e, d), dtype=torch.float32, device=dev),
      dfs=torch.empty((e, g), dtype=torch.float32, device=dev),
      dweights=tuple(torch.empty_like(w) for w in weights),
      dbiases=tuple(torch.empty_like(b) for b in biases),
      dscales=torch.empty_like(scales_raw),
      dlogit=torch.empty_like(logit),
      dobs=torch.empty_like(obs_raw),
  )
  pairs = [int(i) for pair in interactions for i in pair]
  err = lib.bnf_fused_train(
      x_t.data_ptr(), seasonal_t.data_ptr(), y.data_ptr(),
      _ptrs(weights), _ptrs(biases),
      lsa_eff.data_ptr(), fs_raw.data_ptr(), scales_raw.data_ptr(),
      logit.data_ptr(), obs_raw.data_ptr(),
      out['losses'].data_ptr(), out['dlsa'].data_ptr(), out['dfs'].data_ptr(),
      _ptrs(out['dweights']), _ptrs(out['dbiases']),
      out['dscales'].data_ptr(), out['dlogit'].data_ptr(),
      out['dobs'].data_ptr(), scratch.data_ptr(),
      _rsqrts([f] + [width] * depth),
      (ctypes.c_int * d)(*[int(k) for k in fourier_degrees]),
      (ctypes.c_int * max(1, len(pairs)))(*pairs),
      *[v for rep, stride in layout for v in (stride, rep)],
      float(lik_scale), likelihood, code, depth, e, d,
      s2, len(interactions), width, n,
      n if n_valid is None else int(n_valid), chunk_rows, stream,
  )
  _raise_on(err, lib, 'fused_train')
  return (out['losses'], out['dlsa'], out['dfs'], out['dweights'],
          out['dbiases'], out['dscales'], out['dlogit'], out['dobs'])


def fused_train(
    distribution, depth, lik_scale, input_scales, fourier_degrees,
    interactions, x_t, seasonal_t, weights, biases, lsa, fs_raw, scales_raw,
    logit, obs_raw, y, precision='f32', n_valid=None,
):
  """Fused training objective from raw inputs: loss and gradients (K1).

  Per ensemble member e, loss_e = lik_scale * sum_rows -log p(y | pred_e),
  pred_e the field MLP applied to the encode of the raw inputs, under the
  NORMAL model (scale 0.01 + exp(obs_raw[e, 0])), NB (mean softplus(pred),
  shape softplus(obs_raw[e, 1])) or ZINB (NB with zero-inflation
  probability sigmoid(obs_raw[e, 2])); with the gradient with respect to
  every learned input. The caller adds the prior. The kernel evaluates the
  count likelihoods as the TPU kernel does (Stirling gammaln and digamma,
  log-softplus clamped at -15), its plain version exactly; they differ by
  up to ~3e-4 relative.

  Takes the JAX package's arguments, without its TPU-only `tile` and
  `subtiles`. On CPU tensors it returns :func:`fused_train_reference`; on
  CUDA tensors it launches the kernels of `csrc/fused_train.cu` on the
  current stream and counts the call in `fused_train.launches` (and a
  'bf16' call in `fused_train.bf16_launches` too). The call is the
  `bnf.k1` span (`utils/profiling.py`).

  Args:
    distribution: 'NORMAL' | 'NB' | 'ZINB'.
    depth: hidden layers.
    lik_scale: multiplier of the negative log-likelihood.
    input_scales: (D,) static input scale divisors.
    fourier_degrees: (D,) static octave counts.
    interactions: static ((a, b), ...) input-dim pairs.
    x_t: (D, N) raw inputs shared by every member, (E, D, N) per member,
      or (E/rep, D, N) for groups of rep consecutive members (member m reads
      group m // rep; no copy per member is made).
    seasonal_t: (2F, N) seasonal rows (2F may be 0), or (E, 2F, N) /
      (E/rep, 2F, N) as for `x_t`.
    weights: depth + 1 tensors (E, fan_in, fan_out).
    biases: depth + 1 tensors (E, fan_out).
    lsa: (E, D) log scale adjustments.
    fs_raw: (E, G) pre-softplus feature-group scales.
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.
    obs_raw: (E, 3) (log_noise_scale, nb_shape_raw, zinb_logit).
    y: (N,) targets shared by every member, or (E, N) / (E/rep, N); its
      grouping is checked apart from that of `x_t`.
    precision: 'f32' | 'highest' (the same fp32 kernel, bit for bit) |
      'bf16' (the products the TPU kernel casts take bf16-rounded operands,
      exact products and fp32 sums; the output layer's weight gradient,
      the sums and the elementwise math stay fp32; see `ops/mixed.py`).
    n_valid: None (every row counts) or a host int in [0, N]: rows at
      index n_valid and past it contribute nothing to the loss or to any
      gradient, whatever they hold (NaN included: the kernel selects them
      out and never multiplies them by 0). N stays the rows' stride. A row
      shard of a mesh fit passes its valid-row count (stage 4 of the TPU
      kernel, whose `n_valid` is a traced int32).

  Returns:
    (losses (E,), dlsa, dfs_raw, dweights, dbiases, dscales_raw, dlogit,
    dobs_raw), each gradient shaped like its input; the columns of dobs_raw
    that the likelihood does not read are exactly 0 (NORMAL: 1 and 2; NB: 0
    and 2; ZINB: 0).

  Raises:
    ValueError: for an unknown likelihood or precision, an `n_valid` outside
      [0, N], a data input whose leading dim does not divide the member
      count, and on CUDA
      for shapes, dtypes, devices or layouts the kernel does not take.
    RuntimeError: if the kernel fails to build or to launch.
  """
  with profiling.span('bnf.k1'):
    _check_call(distribution, precision, n_valid, x_t.shape[-1])
    _input_layout(weights[0].shape[0], x_t, seasonal_t, y)
    tensors = (x_t, seasonal_t, *weights, *biases, lsa, fs_raw, scales_raw,
               logit, obs_raw, y)
    if all(t.device.type == 'cpu' for t in tensors):
      return fused_train_reference(
          distribution, depth, lik_scale, input_scales, fourier_degrees,
          interactions, x_t, seasonal_t, weights, biases, lsa, fs_raw,
          scales_raw, logit, obs_raw, y, precision, n_valid,
      )
    if x_t.device.type != 'cuda':
      raise ValueError(
          f'fused_train runs on CUDA or CPU tensors, got {x_t.device}.'
      )
    dims = _check_train_inputs(
        depth, input_scales, fourier_degrees, interactions, x_t, seasonal_t,
        weights, biases, lsa, fs_raw, scales_raw, logit, obs_raw, y,
        distribution,
    )
    lib = _train_lib()
    with torch.cuda.device(x_t.device):
      outs = _launch_fused_train(
          lib, torch.cuda.current_stream().cuda_stream, dims, depth,
          lik_scale, input_scales, fourier_degrees, interactions, x_t,
          seasonal_t, weights, biases, lsa, fs_raw, scales_raw, logit,
          obs_raw, y, distribution, precision, n_valid,
      )
    fused_train.launches += 1
    fused_train.bf16_launches += precision == 'bf16'
    return outs


fused_train.launches = 0
fused_train.bf16_launches = 0


# The operand layouts of K1's three 'bf16' products, as `bnf_tc_gemm` codes
# them (see `tc_gemm`).
TC_LAYOUTS = {'forward': 0, 'wdv': 1, 'wgrad': 2}


def _tc_operands(layout, a, b, m, n, k):
  """The (E, M, K) and (E, K, N) matrices `tc_gemm` multiplies, as views of
  its stored operands."""
  if layout == 'forward':
    return a[:, :k, :m].transpose(1, 2), b[:, :k, :n]
  if layout == 'wdv':
    return a[:, :m, :k], b[:, :k, :n]
  return a[:, :m, :k], b[:, :n, :k].transpose(1, 2)


def tc_gemm_reference(layout, a, b, m, n, k) -> torch.Tensor:
  """Plain :func:`tc_gemm`: the bf16 operands' exact products, fp32 sums."""
  a_mk, b_kn = _tc_operands(layout, a, b, m, n, k)
  with mixed.fp32_matmuls():
    return torch.matmul(a_mk.float(), b_kn.float())


def tc_gemm(layout, a, b, m, n, k) -> torch.Tensor:
  """K1's tensor-core GEMM core alone (TMA, mbarrier stages, wgmma; the
  mainloop of its 'bf16' products), for checking it on the card: (E, M, N)
  fp32 = A B over K, per member e.

  Args:
    layout: the operands' layout, as in one of K1's products. 'forward':
      `a` (E, K, lda) holds A(m, k) at [k][m], `b` (E, K, ldb) holds B(k, n)
      at [k][n]; 'wdv': `a` (E, M, lda) holds A(m, k) at [m][k], `b` as for
      'forward'; 'wgrad': `a` as for 'wdv', `b` (E, N, ldb) holds B(k, n) at
      [n][k].
    a, b: contiguous bfloat16 tensors; lda and ldb (their last dims) are
      multiples of 8.
    m, n, k: the product's extents, within the operands'.

  Returns:
    (E, M, N) float32. On CPU tensors :func:`tc_gemm_reference`.

  Raises:
    ValueError: for another layout, dtype or device, or operands that do
      not hold the extents.
    RuntimeError: if the kernel fails to build or to launch.
  """
  if layout not in TC_LAYOUTS:
    raise ValueError(f'tc_gemm: unknown layout {layout!r}.')
  if a.device.type == 'cpu' and b.device.type == 'cpu':
    return tc_gemm_reference(layout, a, b, m, n, k)
  a_rows, a_cols = (k, m) if layout == 'forward' else (m, k)
  b_rows, b_cols = (n, k) if layout == 'wgrad' else (k, n)
  if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
      or a.device.type != 'cuda' or b.device != a.device
      or a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]
      or not (a.is_contiguous() and b.is_contiguous())
      or a.shape[1] < a_rows or a.shape[2] < a_cols
      or b.shape[1] < b_rows or b.shape[2] < b_cols
      or a.shape[2] % 8 or b.shape[2] % 8 or min(m, n, k) < 1):
    raise ValueError(
        f'tc_gemm: expected contiguous bfloat16 CUDA operands holding '
        f'({a_rows}, {a_cols}) and ({b_rows}, {b_cols}) per member with last '
        f'dims a multiple of 8, got {tuple(a.shape)} {a.dtype} and '
        f'{tuple(b.shape)} {b.dtype} on {a.device}, {b.device}.')
  e = a.shape[0]
  out = torch.empty((e, m, n), dtype=torch.float32, device=a.device)
  lib = _train_lib()
  with torch.cuda.device(a.device):
    err = lib.bnf_tc_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), TC_LAYOUTS[layout], e,
        m, n, k, a.shape[2], b.shape[2],
        torch.cuda.current_stream().cuda_stream)
  _raise_on(err, lib, 'tc_gemm')
  tc_gemm.launches += 1
  return out


tc_gemm.launches = 0
