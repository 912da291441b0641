"""Predict-backend resolution (counterpart of `bayesnf_tpu/inference/backends.py`).

- 'torch': the plain PyTorch versions of the kernels (the JAX package's
  'xla' role). Runs on any device.
- 'kernel': the hand-written CUDA kernels (the 'pallas' role). CUDA only.
- 'auto': 'kernel' when the parameters live on a CUDA device, 'torch' when
  they live on the CPU.

There is no fallback: on a CUDA device a kernel that fails to build or to
launch raises, and 'kernel' on the CPU raises.
"""

import torch

BACKENDS = ('torch', 'kernel', 'auto')


def resolve_backend(backend: str, device) -> str:
  """The concrete backend for parameters that live on `device`.

  Raises:
    ValueError: on an unknown backend, or 'kernel' off CUDA.
  """
  if backend not in BACKENDS:
    raise ValueError(f'Unknown backend: {backend!r} (expected {BACKENDS}).')
  is_cuda = torch.device(device).type == 'cuda'
  if backend == 'auto':
    return 'kernel' if is_cuda else 'torch'
  if backend == 'kernel' and not is_cuda:
    raise ValueError(
        f"backend='kernel' runs the CUDA kernels and needs parameters on a "
        f'CUDA device; they are on {device}.'
    )
  return backend
