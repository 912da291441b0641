"""The Normal-mixture quantile search as one CUDA kernel
(`csrc/mixture_quantile.cu`).

It replaces no TPU kernel: the JAX package searches in plain `jnp`
(`bayesnf_tpu/inference/quantiles.py`). It was added because the port's plain
search (`inference/quantiles.normal_mixture_quantiles`, the 'torch'
backend's and the CPU's) runs a fixed 60 iterations of ~107 eager ops for
each quantile, ~19,000 launches a three-quantile predict, though a row has
converged after ~7. The kernel runs up to 32 quantiles of every row in one
launch, and each row stops when it converges, with the plain search's
update, tolerances and answer. What bounds it on an H100 is the FP32 pipe
(erf and a division for each member at each step); the means are read from
device memory once. The source's header says how its design meets that.

`mixture_quantiles` takes CUDA tensors only: it launches the kernel or
raises, with no fallback. Its plain version is
`quantiles.normal_mixture_quantiles` over the flat member axis (the CPU
tests and `chip_smoke.py` compare the two).
"""

import ctypes
import functools

import torch

from bayesnf_torch.ops import _build

_LIB_NAME = 'mixture_quantile'
# Quantiles one launch takes (`kMaxQuantiles` in the source).
MAX_QUANTILES = 32


@functools.cache
def _lib() -> ctypes.CDLL:
  lib = _build.load_library(_LIB_NAME)
  ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
  lib.bnf_mixture_quantiles.argtypes = [
      ptr, i64, ptr,  # means, ld, scales
      ptr, ptr, ptr,  # min_mean, max_mean, max_scale
      ctypes.POINTER(ctypes.c_float), i32,  # quantiles, num_q
      ptr, ptr, ptr,  # out, most, total
      i32, i32, ptr,  # members, rows, stream
  ]
  lib.bnf_mixture_quantiles.restype = ctypes.c_int
  lib.bnf_cuda_error_string.argtypes = [i32]
  lib.bnf_cuda_error_string.restype = ctypes.c_char_p
  return lib


def mixture_quantiles(means, scales, quantiles, stats, most=None,
                      total=None):
  """The exact quantiles of the uniform mixture of Normals of every row.

  Args:
    means: (K, N) float32 CUDA tensor of member means, rows contiguous
      (a slice of a wider array is taken as it is).
    scales: (K,) float32 member scales on the same device.
    quantiles: sequence of Q quantiles in (0, 1).
    stats: (min mean, max mean, max scale), float32 device scalars: the
      bracket [min - 5 max scale, max + 5 max scale] of every row.
    most: None, or a (Q,) int32 tensor on the device that the kernel
      raises to the most iterations any row ran for each quantile.
    total: None, or a (Q,) int64 tensor on the device that the kernel
      raises by the iterations the rows ran, summed, for each quantile.

  Returns:
    (Q, N) float32 roots. One launch for each MAX_QUANTILES quantiles, each
    counted in `mixture_quantiles.launches`; none for no rows or no
    quantiles.

  Raises:
    ValueError: for tensors off CUDA, or of another dtype, shape or layout.
    RuntimeError: if the kernel fails to build or to launch.
  """
  k, n = means.shape if means.ndim == 2 else (0, 0)
  counters = tuple(t for t in (most, total) if t is not None)
  tensors = (means, scales, *stats, *counters)
  if (means.ndim != 2 or means.device.type != 'cuda'
      or any(t.device != means.device for t in tensors)
      or any(t.dtype != torch.float32 for t in (means, scales, *stats))
      or (n > 1 and means.stride(1) != 1) or k < 1
      or (k > 1 and means.stride(0) < n)
      or tuple(scales.shape) != (k,) or not scales.is_contiguous()
      or len(stats) != 3 or any(s.numel() != 1 for s in stats)
      or any(tuple(t.shape) != (len(quantiles),) or not t.is_contiguous()
             for t in counters)
      or (most is not None and most.dtype != torch.int32)
      or (total is not None and total.dtype != torch.int64)):
    raise ValueError(
        'mixture_quantiles: expected float32 CUDA means (K, N) with '
        'contiguous rows, scales (K,) and three scalar stats on its device, '
        f'got means {tuple(means.shape)} {means.dtype} on {means.device}, '
        f'scales {tuple(scales.shape)} {scales.dtype} on {scales.device}.')
  num_q = len(quantiles)
  out = torch.empty((num_q, n), dtype=torch.float32, device=means.device)
  if n == 0 or num_q == 0:
    return out
  lib = _lib()
  with torch.cuda.device(means.device):
    stream = torch.cuda.current_stream().cuda_stream
    for lo in range(0, num_q, MAX_QUANTILES):
      group = [float(q) for q in quantiles[lo:lo + MAX_QUANTILES]]
      err = lib.bnf_mixture_quantiles(
          means.data_ptr(), means.stride(0), scales.data_ptr(),
          *(s.data_ptr() for s in stats),
          (ctypes.c_float * len(group))(*group), len(group),
          out[lo].data_ptr(), *(None if t is None else t[lo].data_ptr()
                                for t in (most, total)),
          k, n, stream)
      if err != 0:
        raise RuntimeError(
            f'mixture_quantiles kernel launch failed: CUDA error {err} '
            f'({lib.bnf_cuda_error_string(err).decode()}).')
      mixture_quantiles.launches += 1
  return out


mixture_quantiles.launches = 0
