"""Ensemble prediction: forecast parameters, means and mixture quantiles
(counterpart of `bayesnf_tpu/inference/predict.py`).

Rows go through the forward in chunks of `chunk_size` (4096), features-major
as in the JAX package: each chunk is encoded per member, runs through the
fused field MLP (the CUDA kernel under the 'kernel' backend, its plain
PyTorch version under 'torch'), and becomes forecast parameters. Ensemble
axes are flattened to one member axis for compute and restored on the way
out. The JAX package's silent fallback from the kernel to the portable
program is not carried over: see `backends.py`.

The rows are padded with zero rows up to a whole number of chunks, as the
JAX package pads them, and the padding is dropped from every result. So the
forward only ever sees whole chunks, and the plain quantile search only the
valid rows rounded up to a multiple of `SEARCH_ROWS` (the 'kernel'
backend's NORMAL search kernel, only the valid rows): the streamed predict
(`predict_stream.py`) makes the same calls chunk by chunk, which keeps it
bit for bit equal to this one on either backend.

NORMAL predicts Normal-mixture quantiles; NB and ZINB build the count
distribution of every member (`distributions.count_obs_dist`) and root-find
the count-mixture quantiles (`quantiles.count_mixture_quantile_root`). The
search's bracket comes from statistics over the valid rows
(`summaries`), which the streamed predict folds chunk by chunk.

Over a mesh (`parallel/mesh.py`) prediction is row-parallel, as in the JAX
package: each chunk's rows, rounded up to a multiple of the mesh's size,
split into one slice per mesh device; the parameters are copied once to
each device, which encodes its slice, runs the forward and makes its
forecast parameters. The slices are gathered in row order on the mesh's
first device, where the quantile root-find runs (on one device: a later
speed item, ROADMAP.md). Over a mesh across ranks
(`parallel/distributed.py`) each rank runs only its own cells' slices, the
slices are gathered in cell order on every rank (`distributed.host_leaves`),
and every rank then runs the search over all rows on its first device, as
the single-process mesh does on its own: the results are the same on every
rank by construction.

While a profiler records (`utils/profiling.py`), the in-memory predict's
forward is the `bnf.predict.forward` span, each chunk's encode in it the
`bnf.predict.encode` span, `summaries` the
`bnf.predict.summaries` span, and each quantile's plain search, or the
search kernel's launch for all of them (one for up to 32), a
`bnf.predict.quantile` span
(`quantiles.py`).
"""

import numpy as np
import torch

from bayesnf_torch.inference import backends
from bayesnf_torch.inference import quantiles as quantiles_lib
from bayesnf_torch.models import distributions as dist_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import fused_mlp
from bayesnf_torch.parallel import distributed
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.utils import profiling


def device_chunk_rows(chunk_size: int, mesh=None) -> int:
  """Rows of one forward chunk: `chunk_size`, over a mesh rounded up to a
  multiple of its size."""
  chunk_size = int(chunk_size)
  if mesh is None:
    return chunk_size
  return -(-chunk_size // mesh.size) * mesh.size


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
    aug: (N, D + 2F) inputs with seasonal features appended, N a multiple
      of `device_chunk_rows(chunk_size, mesh)`.
    chunk_size: rows per chunk (over a mesh, rounded up to a multiple of
      its size).
    backend: 'torch' or 'kernel' (resolved; see `backends.py`).
    mesh: None (every chunk on the parameters' device) or a mesh whose
      devices each take one slice of every chunk (across ranks, each rank
      its own cells' slices).

  Returns:
    Tuple of tensors on the parameters' device (over a mesh, its first
    device, on every rank): per-observation leaves (K, N), per-member
    scalar leaves (K,).
  """
  d = config.num_inputs
  n = aug.shape[0]
  chunk_size = device_chunk_rows(chunk_size, mesh)
  if n % chunk_size:
    raise ValueError(f'{n} rows are not whole chunks of {chunk_size}.')
  forward = (
      fused_mlp.fused_field_mlp_t
      if backend == 'kernel'
      else fused_mlp.fused_field_mlp_t_reference
  )
  home = params_flat[0].device
  if mesh is None:
    mesh = mesh_lib.Mesh([[home]])
  cells = [(i, j) for i, row in enumerate(mesh.devices)
           for j in range(len(row))]
  local = chunk_size // len(cells)
  placed = {}
  for i, j in mesh.local_cells:
    dev = mesh.devices[i][j]
    if dev not in placed:
      pf = tuple(p.to(dev) for p in params_flat)
      placed[dev] = (pf, *field_lib.dense_params(config, pf))
  aug_t = aug.T.contiguous()  # (D + 2F, N): rows last, as the kernel reads.
  slices = []
  for lo in range(0, n, chunk_size):
    for k, (i, j) in enumerate(cells):
      if not mesh.is_local(i, j):
        slices.append(None)
        continue
      dev = mesh.devices[i][j]
      start = lo + k * local
      pf, weights, biases = placed[dev]
      chunk_t = aug_t[:, start : start + local].to(dev)
      with profiling.span('bnf.predict.encode'):
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
  if mesh.is_multiprocess:
    slices = _gather_slices(slices, [mesh.ranks[i][j] for _ in range(
        n // chunk_size) for i, j in cells], home)
  # Per-observation leaves join along rows; scalar leaves are the same in
  # every slice.
  return tuple(
      torch.cat(leaves, dim=1) if leaves[0].ndim == 2 else leaves[0]
      for leaves in zip(*slices)
  )


def _gather_slices(slices, owners, device):
  """Every slice of the forward on every rank (`slices` holds this rank's,
  None for the others; slice k comes from rank `owners[k]`): the per-row
  leaves gathered, the per-member leaves, the same in every slice, this
  rank's."""
  like = next(s for s in slices if s is not None)
  rows = [k for k, leaf in enumerate(like) if leaf.ndim == 2]
  full = distributed.host_leaves(
      [None if s is None else tuple(s[k] for k in rows) for s in slices],
      owners, device)
  return [tuple(f[rows.index(k)] if k in rows else leaf
                for k, leaf in enumerate(like)) for f in full]


def _prepare_predict_inputs(features, params, config, ensemble_dims,
                            backend, mesh, features_on_host=False):
  """The entry contract of the in-memory and the streamed predict.

  Checks that the parameters share one device (over a mesh: moves them to
  its first device), resolves the backend there, and flattens the ensemble
  axes into one member axis. One implementation keeps the two paths'
  placement and backend the same by construction, which their bit-identity
  depends on.

  Args:
    features: (N, D) raw features (numpy or a memmap).
    params: flat parameter tuple with `ensemble_dims` leading axes.
    config: model config.
    ensemble_dims: number of leading ensemble axes.
    backend: 'auto' | 'torch' | 'kernel'.
    mesh: None or a `parallel.mesh.Mesh`.
    features_on_host: keep the features a float32 numpy array (the
      streamed predict) instead of a tensor on the parameters' device.

  Returns:
    (features, params_flat, ensemble shape, resolved backend, mesh).

  Raises:
    ValueError: if the leaves are on several devices, or for a backend
      `backends.resolve_backend` refuses.
  """
  device = params[0].device
  if any(p.device != device for p in params):
    raise ValueError('All parameter leaves must live on one device.')
  if mesh is not None:
    mesh = mesh_lib.check_mesh(mesh)
    params = tuple(p.to(mesh.first_device) for p in params)
    device = mesh.first_device
  backend = backends.resolve_backend(
      backend, device if mesh is None else mesh.device_type, config)
  features = np.asarray(features, dtype=np.float32)
  if not features_on_host:
    features = torch.as_tensor(features, device=device)
  ens_shape = tuple(params[0].shape[:ensemble_dims])
  k = int(np.prod(ens_shape))
  params_flat = tuple(
      p.reshape((k,) + tuple(p.shape[ensemble_dims:])) for p in params
  )
  return features, params_flat, ens_shape, backend, mesh


def _padded_forecast_params(config, distribution, params_flat, features,
                            chunk_size, backend, mesh):
  """`_forecast_params_chunked` over `features` (N, D) padded with zero rows
  to whole chunks: per-row leaves (K, N rounded up)."""
  n = features.shape[0]
  chunk = device_chunk_rows(chunk_size, mesh)
  padded = torch.zeros((-(-n // chunk) * chunk, features.shape[1]),
                       dtype=torch.float32, device=features.device)
  padded[:n] = features
  return _forecast_params_chunked(
      config, distribution, params_flat,
      field_lib.aug_features(config, padded), chunk_size=chunk_size,
      backend=backend, mesh=mesh)


def summaries(distribution, fp, valid):
  """(means, bracket statistics) of flat forecast parameters `fp`.

  The means are the public ones: the NORMAL locations, or the count
  distribution's means (K, rows). The statistics are the quantile search's
  bracket statistics over the first `valid` rows: (min mean, max mean) for
  NORMAL, (max mean, max stddev) for the count models. Each is a min or a
  max, which no order of rows changes, so the streamed predict folds them
  chunk by chunk (`fold_summaries`) to these very values.
  """
  with profiling.span('bnf.predict.summaries'):
    if likelihoods.LikelihoodDist(distribution) == (
        likelihoods.LikelihoodDist.NORMAL):
      means = fp[0]
      return means, (torch.amin(means[:, :valid]),
                     torch.amax(means[:, :valid]))
    obs_d = dist_lib.count_obs_dist(*fp)
    means = obs_d.mean()
    return means, (torch.amax(means[:, :valid]),
                   torch.amax(obs_d.stddev()[:, :valid]))


def fold_summaries(distribution, stats, more):
  """The bracket statistics of two row sets from those of each."""
  if likelihoods.LikelihoodDist(distribution) == (
      likelihoods.LikelihoodDist.NORMAL):
    return torch.minimum(stats[0], more[0]), torch.maximum(stats[1], more[1])
  return torch.maximum(stats[0], more[0]), torch.maximum(stats[1], more[1])


# The quantile search runs on the valid rows padded with zero rows, or cut
# from the forward's padded ones, to a multiple of this: a mean over the
# members of such an array (`quantiles.member_mean`) takes one order of sums
# whatever its width, on the CPU (its vector loops take 32 or 64 columns at
# a time) and on CUDA (4-wide vector loads over at least 128 columns, in
# blocks of at most 1,020 members added in order), so a chunk's search gives
# the whole array's values bit for bit at any member count.
SEARCH_ROWS = 128


def quantile_rows(distribution, fp, ens_shape, quantiles, approximate,
                  stats, valid, backend):
  """(num quantiles, valid) mixture quantiles of the first `valid` rows of
  flat forecast parameters `fp` on the bracket of `stats` (`summaries`).

  Under the 'kernel' backend (resolved) the exact NORMAL quantiles take the
  search kernel, one launch for up to 32 of them
  (`quantiles.normal_mixture_quantiles_kernel`), on the valid rows alone:
  its sum over the members takes one order whatever the rows. Everything
  else (the 'torch' backend, the count models, approximate quantiles) takes
  the plain search over the valid rows rounded up to SEARCH_ROWS.
  """
  axis = tuple(range(len(ens_shape)))
  if not quantiles:
    return torch.empty((0, valid), device=fp[0].device)
  normal = likelihoods.LikelihoodDist(distribution) == (
      likelihoods.LikelihoodDist.NORMAL)
  if backend == 'kernel' and normal and not approximate:
    return quantiles_lib.normal_mixture_quantiles_kernel(
        fp[0][:, :valid], fp[1], quantiles, stats)
  searched = -(-valid // SEARCH_ROWS) * SEARCH_ROWS
  fp = tuple(f if f.ndim == 1 else f[:, :searched] if f.shape[1] >= searched
             else torch.nn.functional.pad(f, (0, searched - f.shape[1]))
             for f in fp)

  def expand(leaf):
    return leaf.reshape(ens_shape + tuple(leaf.shape[1:]))

  if normal:
    q = quantiles_lib.normal_mixture_quantiles(
        expand(fp[0]), expand(fp[1]), quantiles, axis, approximate,
        stats=stats)
  else:
    obs_d = dist_lib.count_obs_dist(*(expand(f) for f in fp))
    q = [quantiles_lib.count_mixture_quantile_root(
        obs_d, q, ensemble_axes=axis, stats=stats) for q in quantiles]
  return _valid_rows(torch.stack(q), valid)


def _valid_rows(leaf, n):
  """`leaf`'s first `n` rows (its last axis), copied only if it has more."""
  return leaf if leaf.shape[-1] == n else leaf[..., :n].contiguous()


def forecast_params_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    ensemble_dims: int = 2,
    chunk_size: int = 4096,
    backend: str = 'auto',
    mesh=None,
    stream_chunk_rows: int | None = None,
    stream_cache_bytes: int | None = None,
):
  """Per-member forecast distribution parameters at new points.

  Returns the raw parameter tuple of `likelihoods.forecast_params`, each
  leaf reshaped to the ensemble axes of `params`: per-row leaves
  `ensemble_shape + (N,)`, scalar leaves `ensemble_shape`. Over `mesh` the
  rows run row-parallel on its devices and the leaves come back on its
  first device.

  With `stream_chunk_rows` the rows stream from the host through the device
  in chunks of that many rows, and the leaves come back as CPU tensors,
  bit for bit these (`predict_stream.forecast_params_bnf_streamed`).
  `stream_cache_bytes` is accepted for the JAX package's signature and
  ignored (`predict_stream.py`).
  """
  del stream_cache_bytes
  if stream_chunk_rows is not None:
    from bayesnf_torch.inference import predict_stream  # pylint: disable=g-import-not-at-top

    return predict_stream.forecast_params_bnf_streamed(
        features, observation_model, params, config,
        ensemble_dims=ensemble_dims, chunk_size=chunk_size, backend=backend,
        mesh=mesh, stream_chunk_rows=stream_chunk_rows)
  distribution = likelihoods.LikelihoodDist(observation_model)
  features, params_flat, ens_shape, backend, mesh = _prepare_predict_inputs(
      features, params, config, ensemble_dims, backend, mesh)
  n = features.shape[0]
  fp = _padded_forecast_params(config, distribution, params_flat, features,
                               chunk_size, backend, mesh)
  return tuple(
      _valid_rows(f, n).reshape(ens_shape + (n,)) if f.ndim == 2
      else f.reshape(ens_shape)
      for f in fp)


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
    stream_chunk_rows: int | None = None,
    stream_cache_bytes: int | None = None,
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
    stream_chunk_rows: None (the whole table on the device), or the rows of
      a host chunk of the streamed predict
      (`predict_stream.predict_bnf_streamed`): device memory O(chunk), the
      results CPU tensors, bit for bit these (the approximate quantiles
      to within rounding).
    stream_cache_bytes: accepted for the JAX package's signature and
      ignored: the streamed predict keeps no device cache
      (`predict_stream.py`).

  Returns:
    (means, [quantile tensors]) on the parameters' device (over a mesh, its
    first device; streamed, the CPU): means has shape `ensemble_shape +
    (N,)`, each quantile (N,).
  """
  del stream_cache_bytes
  if stream_chunk_rows is not None:
    from bayesnf_torch.inference import predict_stream  # pylint: disable=g-import-not-at-top

    return predict_stream.predict_bnf_streamed(
        features, observation_model, params, config, quantiles,
        ensemble_dims=ensemble_dims,
        approximate_quantiles=approximate_quantiles, chunk_size=chunk_size,
        backend=backend, mesh=mesh, stream_chunk_rows=stream_chunk_rows)
  distribution = likelihoods.LikelihoodDist(observation_model)
  with profiling.span('bnf.predict.forward'):
    features, params_flat, ens_shape, backend, mesh = (
        _prepare_predict_inputs(features, params, config, ensemble_dims,
                                backend, mesh))
    n = features.shape[0]
    fp = _padded_forecast_params(config, distribution, params_flat,
                                 features, chunk_size, backend, mesh)
  del features  # Off the device before the search, which needs only fp.
  means, stats = summaries(distribution, fp, n)
  q = quantile_rows(distribution, fp, ens_shape,
                    tuple(float(q) for q in quantiles),
                    approximate_quantiles, stats, n, backend)
  return (_valid_rows(means, n).reshape(ens_shape + (n,)),
          list(q.unbind(0)))
