"""Ensemble prediction: forecast parameters, means and mixture quantiles
(counterpart of `bayesnf_tpu/inference/predict.py`).

Rows go through the forward in chunks of `chunk_size` (4096), features-major
as in the JAX package: each chunk is encoded per member, runs through the
fused field MLP (the CUDA kernel under the 'kernel' backend, its plain
PyTorch version under 'torch'), and becomes forecast parameters. Ensemble
axes are flattened to one member axis for compute and restored on the way
out. The JAX package's silent fallback from the kernel to the portable
program is not carried over: see `backends.py`.

Only the NORMAL observation model predicts here; the count models' mixture
quantiles arrive with their slice (ROADMAP.md, queue 1 item 10).
"""

import numpy as np
import torch

from bayesnf_torch.inference import backends
from bayesnf_torch.inference import quantiles as quantiles_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import fused_mlp


def _forecast_params_chunked(
    config, distribution, params_flat, aug, chunk_size=4096, backend='torch'
):
  """Per-member forecast distribution parameters over all rows.

  Args:
    config: model config.
    distribution: observation model.
    params_flat: flat parameter tuple, each leaf with one leading member
      axis K.
    aug: (N, D + 2F) inputs with seasonal features appended.
    chunk_size: rows per chunk.
    backend: 'torch' or 'kernel' (resolved; see `backends.py`).

  Returns:
    Tuple of tensors: per-observation leaves (K, N), per-member scalar
    leaves (K,).
  """
  d = config.num_inputs
  n = aug.shape[0]
  forward = (
      fused_mlp.fused_field_mlp_t
      if backend == 'kernel'
      else fused_mlp.fused_field_mlp_t_reference
  )
  weights, biases = field_lib.dense_params(config, params_flat)
  aug_t = aug.T.contiguous()  # (D + 2F, N): rows last, as the kernel reads.
  chunks = []
  for lo in range(0, n, chunk_size):
    chunk_t = aug_t[:, lo : lo + chunk_size]
    groups = field_lib.encode_t_groups(
        config, params_flat, chunk_t[:d], chunk_t[d:]
    )
    pred = forward(
        config.depth, groups, weights, biases,
        params_flat[field_lib.IDX_LAYER_SCALES],
        params_flat[field_lib.IDX_ACTIVATION_LOGIT],
    )
    chunks.append(
        likelihoods.forecast_params(distribution, params_flat, pred)
    )
  # Per-observation leaves join along rows; scalar leaves are the same in
  # every chunk.
  return tuple(
      torch.cat(leaves, dim=1) if leaves[0].ndim == 2 else leaves[0]
      for leaves in zip(*chunks)
  )


def forecast_params_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    ensemble_dims: int = 2,
    chunk_size: int = 4096,
    backend: str = 'auto',
):
  """Per-member forecast distribution parameters at new points.

  Returns the raw parameter tuple of `likelihoods.forecast_params`, each
  leaf reshaped to the ensemble axes of `params`: per-row leaves
  `ensemble_shape + (N,)`, scalar leaves `ensemble_shape`.
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  device = params[0].device
  if any(p.device != device for p in params):
    raise ValueError('All parameter leaves must live on one device.')
  backend = backends.resolve_backend(backend, device)
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
):
  """Predict means and mixture quantiles at new points.

  Args:
    features: (N, D) raw feature matrix (post data-handler scaling), numpy.
    observation_model: 'NORMAL' (the count models arrive later).
    params: flat parameter tuple of tensors on one device, each leaf with
      `ensemble_dims` leading ensemble axes ((G, M, ...) for MAP).
    config: model config.
    quantiles: sequence of quantiles in (0, 1).
    ensemble_dims: number of leading ensemble axes on each leaf.
    approximate_quantiles: moment-matched Normal instead of root-finding.
    chunk_size: rows per forward chunk.
    backend: 'auto' | 'torch' | 'kernel' (see `backends.py`).

  Returns:
    (means, [quantile tensors]) on the parameters' device: means has shape
    `ensemble_shape + (N,)`, each quantile (N,).
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  if distribution != likelihoods.LikelihoodDist.NORMAL:
    raise NotImplementedError(
        f'Predicting the {distribution.value} model is not ported yet (count '
        'mixture quantiles: ROADMAP.md, queue 1 item 10).'
    )
  means, scales = forecast_params_bnf(
      features, observation_model, params, config,
      ensemble_dims=ensemble_dims, chunk_size=chunk_size, backend=backend,
  )
  return means, quantiles_lib.normal_mixture_quantiles(
      means, scales, tuple(float(q) for q in quantiles),
      axis=tuple(range(ensemble_dims)), approximate=approximate_quantiles,
  )
