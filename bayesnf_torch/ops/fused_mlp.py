"""Fused ensemble field-MLP forward (counterpart of the features-major forward
in `bayesnf_tpu/ops/fused_mlp.py`).

Per ensemble member e:

    h_0 = concat(feature groups)                       (E, F, N)
    for l in 0..depth-1:
        z_l = s_l * (W_l^T (h_l / sqrt(fan_in)) + b_l)
        h_{l+1} = w * elu(z_l) + (1 - w) * tanh(z_l)
    pred = s_out * (W_out^T (h_depth / sqrt(width)) + b_out)[0]

with s_l = softplus(layer_scales_raw[l]) and w = sigmoid(activation_logit).

`fused_field_mlp_t` launches the hand-written CUDA kernel
(`csrc/fused_mlp_fwd.cu`, which replaces the Pallas kernel
`_forward_kernel_t`) on CUDA tensors, and computes
`fused_field_mlp_t_reference`, the plain PyTorch version, on CPU tensors.
It never falls back: on a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import functools
import math

import torch

from bayesnf_torch.ops import _build
from bayesnf_torch.ops import special

_LIB_NAME = 'fused_mlp_fwd'
MAX_DEPTH = 8  # kMaxLayers - 1 in the kernel source.
MAX_MEMBERS = 65535  # gridDim.y.
# Opt-in shared memory of one block on sm_90 (227 KB).
MAX_SHARED_BYTES = 232448
TILE_ROWS = (32, 16)  # The kernel's instantiations, largest first.


def _act(z: torch.Tensor, w) -> torch.Tensor:
  """w * elu(z) + (1 - w) * tanh(z), with the JAX package's formulas."""
  q = torch.exp(torch.clamp(z, max=0.0))
  elu = torch.where(z > 0, z, q - 1.0)
  return w * elu + (1.0 - w) * torch.tanh(z)


def fused_field_mlp_t_reference(
    depth, h0_groups, weights, biases, scales_raw, logit
) -> torch.Tensor:
  """Plain PyTorch forward: one `torch.matmul` per layer.

  Args:
    depth: hidden layers.
    h0_groups: sequence of (E, f_g, N) feature-group tensors.
    weights: depth + 1 tensors (E, fan_in, fan_out); the last has fan_out 1.
    biases: depth + 1 tensors (E, fan_out).
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.

  Returns:
    (E, N) predictions.
  """
  h = torch.cat(tuple(h0_groups), dim=1)
  s = special.softplus(scales_raw)
  w = torch.sigmoid(logit)[:, None, None]
  for l in range(depth + 1):
    z = torch.matmul(weights[l].transpose(1, 2), h * (1.0 / math.sqrt(h.shape[1])))
    z = s[:, l, None, None] * (z + biases[l][:, :, None])
    if l < depth:
      h = _act(z, w)
  return z[:, 0, :]


def pick_tile_rows(num_features: int, width: int) -> int:
  """Rows per block: the largest instantiated tile whose buffers fit.

  Raises:
    ValueError: if even the smallest tile does not fit in shared memory.
  """
  fn = _lib().bnf_fused_mlp_t_fwd_smem_bytes
  for tile_rows in TILE_ROWS:
    if fn(tile_rows, num_features, width) <= MAX_SHARED_BYTES:
      return tile_rows
  raise ValueError(
      f'fused_field_mlp_t: width {width} with {num_features} input features '
      f'does not fit a {TILE_ROWS[-1]}-row tile in {MAX_SHARED_BYTES} bytes '
      'of shared memory.'
  )


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load_library(_LIB_NAME)
  lib.bnf_fused_mlp_t_fwd.argtypes = [
      ctypes.c_void_p,  # h0
      ctypes.POINTER(ctypes.c_void_p),  # weights
      ctypes.POINTER(ctypes.c_void_p),  # biases
      ctypes.c_void_p,  # scales_raw
      ctypes.c_void_p,  # logit
      ctypes.c_void_p,  # out
      ctypes.POINTER(ctypes.c_float),  # rsqrts
      ctypes.c_int,  # depth
      ctypes.c_int,  # num_members
      ctypes.c_int,  # num_features
      ctypes.c_int,  # width
      ctypes.c_int,  # n_rows
      ctypes.c_int,  # tile_rows
      ctypes.c_void_p,  # stream
  ]
  lib.bnf_fused_mlp_t_fwd.restype = ctypes.c_int
  lib.bnf_fused_mlp_t_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
  lib.bnf_fused_mlp_t_fwd_smem_bytes.restype = ctypes.c_size_t
  lib.bnf_cuda_error_string.argtypes = [ctypes.c_int]
  lib.bnf_cuda_error_string.restype = ctypes.c_char_p
  return lib


def _check_inputs(depth, h0, weights, biases, scales_raw, logit):
  """Raises ValueError on anything the kernel does not take."""
  e, f, _ = h0.shape
  if not 0 <= depth <= MAX_DEPTH:
    raise ValueError(f'depth must be in [0, {MAX_DEPTH}], got {depth}.')
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


def fused_field_mlp_t(
    depth, h0_groups, weights, biases, scales_raw, logit
) -> torch.Tensor:
  """Fused forward: (E, f_g, N) feature groups -> (E, N) predictions.

  Takes the JAX package's layout and arguments (without its TPU-only `tile`
  and `precision`). On CPU tensors it returns
  :func:`fused_field_mlp_t_reference`; on CUDA tensors it launches the
  kernel on the current stream and counts the launch in
  `fused_field_mlp_t.launches`.

  Raises:
    ValueError: on shapes, dtypes, devices or layouts the kernel does not
      take, or a width whose tile does not fit in shared memory.
    RuntimeError: if the kernel fails to build or to launch.
  """
  tensors = (*h0_groups, *weights, *biases, scales_raw, logit)
  if all(t.device.type == 'cpu' for t in tensors):
    return fused_field_mlp_t_reference(
        depth, h0_groups, weights, biases, scales_raw, logit
    )
  if h0_groups[0].device.type != 'cuda':
    raise ValueError(
        f'fused_field_mlp_t runs on CUDA or CPU tensors, got '
        f'{h0_groups[0].device}.'
    )
  # The kernel reads one (E, F, N) buffer, so several groups are joined
  # here: one extra copy of the encoded inputs (E * F * N floats), small
  # beside the kernel's E * N * width^2 FMAs.
  h0 = h0_groups[0] if len(h0_groups) == 1 else torch.cat(tuple(h0_groups), 1)
  width = _check_inputs(depth, h0, weights, biases, scales_raw, logit)
  e, f, n = h0.shape
  out = torch.empty((e, n), dtype=torch.float32, device=h0.device)
  if n == 0:
    return out
  tile_rows = pick_tile_rows(f, width)
  fan_ins = [f] + [width] * depth
  # 1/sqrt(fan_in) in double, rounded to float32 (as the JAX package does).
  rsqrts = (ctypes.c_float * (depth + 1))(
      *[1.0 / math.sqrt(fi) for fi in fan_ins]
  )
  w_ptrs = (ctypes.c_void_p * (depth + 1))(*[w.data_ptr() for w in weights])
  b_ptrs = (ctypes.c_void_p * (depth + 1))(*[b.data_ptr() for b in biases])
  lib = _lib()
  with torch.cuda.device(h0.device):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.bnf_fused_mlp_t_fwd(
        h0.data_ptr(), w_ptrs, b_ptrs, scales_raw.data_ptr(),
        logit.data_ptr(), out.data_ptr(), rsqrts, depth, e, f, width, n,
        tile_rows, stream,
    )
  if err != 0:
    raise RuntimeError(
        f'fused_field_mlp_t kernel launch failed: CUDA error {err} '
        f'({lib.bnf_cuda_error_string(err).decode()}).'
    )
  fused_field_mlp_t.launches += 1
  return out


fused_field_mlp_t.launches = 0
