"""Backend resolution (counterpart of `bayesnf_tpu/inference/backends.py`).

- 'torch': the plain PyTorch versions of the kernels (the JAX package's
  'xla' role). Runs on any device, any model and any mesh.
- 'kernel': the hand-written CUDA kernels (the 'pallas' role). CUDA only.
- 'auto': 'kernel' when the computation runs on a CUDA device and the kernel
  takes it, 'torch' otherwise.

The JAX package's 'auto' falls back to 'xla', with a warning, when its
kernel program fails to build. The port decides from shapes instead, before
anything runs: 'auto' asks the kernel wrapper's own checks, which need no
library (for a fit K1's `fused_mlp.check_train_shape`, for a predict K2's
`check_forward_shape`; both take any width) and picks 'torch' for a model
the kernel does not take (more inputs, interaction pairs or depth than K1
holds; more depth than K2 holds), and for
a minibatch over a sharded data axis whose batch does not split evenly
over the shards (the kernel path draws batch_size / data_shards rows per
shard).
Nothing catches a build or launch error: on a CUDA device a kernel that
fails to build or to launch raises, explicit 'kernel' raises for shapes it
cannot take, and 'kernel' off CUDA raises.
"""

import torch

from bayesnf_torch.ops import fused_mlp

BACKENDS = ('torch', 'kernel', 'auto')


def kernel_takes(config, distribution=None) -> bool:
  """Whether the kernel of a fit under `distribution` (K1), or of a predict
  when `distribution` is None (K2), takes the model of `config`; neither
  check builds a library."""
  try:
    if distribution is None:
      fused_mlp.check_forward_shape(config.depth)
    else:
      fused_mlp.check_train_shape(
          distribution, config.depth, config.width, config.fourier_degrees,
          config.interactions, config.num_seasonal_features)
  except ValueError:
    return False
  return True


def resolve_backend(backend: str, device, config=None, distribution=None,
                    data_shards: int = 1, full_batch: bool = False,
                    batch_divisible: bool = False) -> str:
  """The concrete backend of a computation on `device`.

  Args:
    backend: 'auto' | 'torch' | 'kernel'.
    device: where the computation runs (a mesh's devices share its type).
    config: the model's config; with it 'auto' picks 'kernel' only for a
      model the kernel takes (`kernel_takes`).
    distribution: the likelihood of a fit ('NORMAL', 'NB', 'ZINB'; its K1
      call), or None for a predict (K2).
    data_shards: extent of the mesh's data axis.
    full_batch: the fit steps on every row.
    batch_divisible: batch_size % data_shards == 0. As in the JAX package it
      defaults to False, the safe side: a sharded minibatch that omits it
      resolves to 'torch'.

  Raises:
    ValueError: on an unknown backend, or 'kernel' off CUDA.
  """
  if backend not in BACKENDS:
    raise ValueError(f'Unknown backend: {backend!r} (expected {BACKENDS}).')
  is_cuda = torch.device(device).type == 'cuda'
  if backend == 'auto':
    if not is_cuda or (data_shards > 1 and not full_batch
                       and not batch_divisible):
      return 'torch'
    if config is not None and not kernel_takes(config, distribution):
      return 'torch'
    return 'kernel'
  if backend == 'kernel' and not is_cuda:
    raise ValueError(
        f"backend='kernel' runs the CUDA kernels and needs parameters on a "
        f'CUDA device; they are on {device}.'
    )
  return backend
