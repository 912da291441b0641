"""Ensemble prediction: forecast parameters, means and mixture quantiles
(counterpart of `bayesnf_tpu/inference/predict.py`).

Rows go through the forward in chunks of `chunk_size` (4096), features-major
as in the JAX package: each chunk is encoded per member, runs through the
fused field MLP (the CUDA kernel under the 'kernel' backend, its plain
PyTorch version under 'torch'), and becomes forecast parameters. Ensemble
axes are flattened to one member axis for compute and restored on the way
out. The JAX package's silent fallback from the kernel to the portable
program is not carried over: see `backends.py`.

NORMAL predicts Normal-mixture quantiles; NB and ZINB build the count
distribution of every member (`distributions.count_obs_dist`) and root-find
the count-mixture quantiles (`quantiles.count_mixture_quantile_root`).

Over a mesh (`parallel/mesh.py`) prediction is row-parallel, as in the JAX
package: each chunk's rows, rounded up to a multiple of the mesh's size,
split into one slice per mesh device; the parameters are copied once to
each device, which encodes its slice, runs the forward and makes its
forecast parameters. The slices are gathered in row order on the mesh's
first device, where the quantile root-find runs (on one device: a later
speed item, ROADMAP.md).
"""

import numpy as np
import torch

from bayesnf_torch.inference import backends
from bayesnf_torch.inference import quantiles as quantiles_lib
from bayesnf_torch.models import distributions as dist_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import fused_mlp
from bayesnf_torch.parallel import mesh as mesh_lib


def _forecast_params_chunked(
    config, distribution, params_flat, aug, chunk_size=4096, backend='torch',
    mesh=None,
):
  """Per-member forecast distribution parameters over all rows.

  Args:
    config: model config.
    distribution: observation model.
    params_flat: flat parameter tuple, each leaf with one leading member
      axis K.
    aug: (N, D + 2F) inputs with seasonal features appended.
    chunk_size: rows per chunk (over a mesh, rounded up to a multiple of
      its size).
    backend: 'torch' or 'kernel' (resolved; see `backends.py`).
    mesh: None (every chunk on the parameters' device) or a mesh whose
      devices each take one slice of every chunk.

  Returns:
    Tuple of tensors on the parameters' device (over a mesh, its first
    device): per-observation leaves (K, N), per-member scalar leaves (K,).
  """
  d = config.num_inputs
  n = aug.shape[0]
  forward = (
      fused_mlp.fused_field_mlp_t
      if backend == 'kernel'
      else fused_mlp.fused_field_mlp_t_reference
  )
  if mesh is None:
    devices = [params_flat[0].device]
  else:
    devices = [dev for row in mesh.devices for dev in row]
    chunk_size = -(-chunk_size // len(devices)) * len(devices)
  home = devices[0]
  local = chunk_size // len(devices)
  placed = {}
  for dev in devices:
    if dev not in placed:
      pf = tuple(p.to(dev) for p in params_flat)
      placed[dev] = (pf, *field_lib.dense_params(config, pf))
  aug_t = aug.T.contiguous()  # (D + 2F, N): rows last, as the kernel reads.
  slices = []
  for lo in range(0, n, chunk_size):
    for k, dev in enumerate(devices):
      start = lo + k * local
      if start >= n:
        break
      pf, weights, biases = placed[dev]
      chunk_t = aug_t[:, start : start + local].to(dev)
      groups = field_lib.encode_t_groups(
          config, pf, chunk_t[:d], chunk_t[d:]
      )
      pred = forward(
          config.depth, groups, weights, biases,
          pf[field_lib.IDX_LAYER_SCALES],
          pf[field_lib.IDX_ACTIVATION_LOGIT],
      )
      slices.append(tuple(
          f.to(home)
          for f in likelihoods.forecast_params(distribution, pf, pred)))
  # Per-observation leaves join along rows; scalar leaves are the same in
  # every slice.
  return tuple(
      torch.cat(leaves, dim=1) if leaves[0].ndim == 2 else leaves[0]
      for leaves in zip(*slices)
  )


def forecast_params_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    ensemble_dims: int = 2,
    chunk_size: int = 4096,
    backend: str = 'auto',
    mesh=None,
):
  """Per-member forecast distribution parameters at new points.

  Returns the raw parameter tuple of `likelihoods.forecast_params`, each
  leaf reshaped to the ensemble axes of `params`: per-row leaves
  `ensemble_shape + (N,)`, scalar leaves `ensemble_shape`. Over `mesh` the
  rows run row-parallel on its devices and the leaves come back on its
  first device.
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  device = params[0].device
  if any(p.device != device for p in params):
    raise ValueError('All parameter leaves must live on one device.')
  if mesh is not None:
    mesh = mesh_lib.check_mesh(mesh)
    params = tuple(p.to(mesh.first_device) for p in params)
    device = mesh.first_device
  backend = backends.resolve_backend(
      backend, device if mesh is None else mesh.device_type, config)
  features = torch.as_tensor(
      np.asarray(features, dtype=np.float32), device=device
  )
  ens_shape = tuple(params[0].shape[:ensemble_dims])
  k = int(np.prod(ens_shape))
  params_flat = tuple(
      p.reshape((k,) + tuple(p.shape[ensemble_dims:])) for p in params
  )
  fp = _forecast_params_chunked(
      config, distribution, params_flat, field_lib.aug_features(
          config, features), chunk_size=int(chunk_size), backend=backend,
      mesh=mesh,
  )
  return tuple(f.reshape(ens_shape + f.shape[1:]) for f in fp)


def predict_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    quantiles,
    ensemble_dims: int = 2,
    approximate_quantiles: bool = False,
    chunk_size: int = 4096,
    backend: str = 'auto',
    mesh=None,
):
  """Predict means and mixture quantiles at new points.

  Args:
    features: (N, D) raw feature matrix (post data-handler scaling), numpy.
    observation_model: 'NORMAL' | 'NB' | 'ZINB'.
    params: flat parameter tuple of tensors on one device, each leaf with
      `ensemble_dims` leading ensemble axes ((G, M, ...) for MAP).
    config: model config.
    quantiles: sequence of quantiles in (0, 1).
    ensemble_dims: number of leading ensemble axes on each leaf.
    approximate_quantiles: moment-matched Normal instead of root-finding
      (NORMAL only; the count models always root-find, as in the JAX
      package).
    chunk_size: rows per forward chunk.
    backend: 'auto' | 'torch' | 'kernel' (see `backends.py`).
    mesh: None, or a `parallel.mesh.Mesh` over whose devices the forward
      runs row-parallel (`_forecast_params_chunked`).

  Returns:
    (means, [quantile tensors]) on the parameters' device (over a mesh, its
    first device): means has shape `ensemble_shape + (N,)`, each quantile
    (N,).
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  fp = forecast_params_bnf(
      features, observation_model, params, config,
      ensemble_dims=ensemble_dims, chunk_size=chunk_size, backend=backend,
      mesh=mesh,
  )
  quantiles = tuple(float(q) for q in quantiles)
  axis = tuple(range(ensemble_dims))
  if distribution == likelihoods.LikelihoodDist.NORMAL:
    means, scales = fp
    return means, quantiles_lib.normal_mixture_quantiles(
        means, scales, quantiles, axis=axis,
        approximate=approximate_quantiles,
    )
  obs_d = dist_lib.count_obs_dist(*fp)
  return obs_d.mean(), [
      quantiles_lib.count_mixture_quantile_root(obs_d, q, ensemble_axes=axis)
      for q in quantiles
  ]
