"""Host-streamed prediction (counterpart of
`bayesnf_tpu/inference/predict_stream.py`).

The in-memory predict (`predict.py`) puts the whole grid on the device and
keeps O(members x N) forecast parameters there, and the quantile search's
(members, N) temporaries. Here the grid stays on the host (a numpy array or
an `np.memmap`), row chunks stream through the device one at a time, and
the results are assembled in host memory, so a model fitted on a table
larger than the card (`parallel/streaming.py`) can also predict on it.

- **Two passes.** The exact mixture quantiles search a bracket made from
  statistics over all rows (`predict.summaries`: the extreme means and
  standard deviations). Pass 1 runs the forward chunk by chunk, sends each
  chunk's public leaves to the host and folds its statistics into running
  ones on the device; minima and maxima are exact, so they end equal to the
  in-memory ones. Pass 2 runs the quantile search chunk by chunk on that
  bracket. Both passes make the in-memory predict's calls: host chunks are
  whole device chunks (`chunk_size`, the last padded with zero rows as the
  in-memory predict pads its tail), so the forward sees the same chunks,
  and every quantile search runs on the valid rows rounded up to a
  multiple of `predict.SEARCH_ROWS`, whose sums over the members take one
  order whatever the width (`quantiles.member_mean`: past 1,020 members
  CUDA's own reduction would split the sums over thread blocks by the
  width, so they go in blocks of 1,020 added in order; held on an H100 at
  1,920 members, `chip_smoke.py` phase 16). The results are the
  in-memory predict's bit for bit (tested), but the approximate quantiles,
  which are held to rounding (rtol 1e-6) as in the JAX package.
- **No device cache.** Pass 2 re-uploads the leaves it searches on (the
  NORMAL means; the count models' logits and zero-inflation probabilities)
  from the host buffers pass 1 filled, so device memory stays
  O(stream_chunk_rows) whatever N is. The JAX package can keep those
  leaves on the device up to `stream_cache_bytes` (1 GiB by default);
  here the argument is accepted for its signature and ignored, since the
  results are the same bits at any budget and a re-upload over PCIe costs
  little beside a chunk's quantile search.
- **Copies in CUDA's idiom.** Uploads go through pinned host buffers and a
  side stream in two slots (`streaming.HostUploads`), one chunk ahead in
  pass 2; results come back into pinned buffers behind an event, one chunk
  deep (`_Fetches`), so the host assembles chunk k while chunk k + 1
  computes. Nothing a copy reads or writes is reused or freed before the
  copy's event.
- Over a mesh (`parallel/mesh.py`) pass 1 runs each chunk row-parallel
  through `predict._forecast_params_chunked`, host chunks whole chunks of
  the mesh-rounded size, and pass 2 runs on the mesh's first device, as in
  the in-memory predict. Across ranks (`parallel/distributed.py`) every
  rank uploads each host chunk to its first device, runs only its own
  cells' slices of it, and gathers the chunk's slices in cell order; every
  rank then runs pass 2 over all rows, so the results are equal on every
  rank and bit for bit the in-memory predict's.
"""

import numpy as np
import torch

from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.parallel import streaming as streaming_lib

NORMAL = likelihoods.LikelihoodDist.NORMAL


def _resolve_rows(stream_chunk_rows: int, chunk_size: int, n: int) -> int:
  """Rows of a host chunk: `stream_chunk_rows` rounded up to whole device
  chunks of `chunk_size` rows, and no more than the table's."""
  if n < 1:
    raise ValueError(
        'streamed prediction needs at least one row (got an empty table).')
  rows = -(-max(int(stream_chunk_rows), 1) // chunk_size) * chunk_size
  return min(rows, -(-n // chunk_size) * chunk_size)


def _chunk_ranges(n, rows):
  for lo in range(0, n, rows):
    yield lo, min(lo + rows, n)


class _Fetches:
  """Device-to-host copies of one group of tensors a chunk, one chunk deep.

  `dispatch` queues chunk k's copies into pinned buffers and records an
  event after them on the current stream of `device`, where the copies run;
  then it waits for chunk k - 1's event and hands its host copies to its
  `store`. `drain` hands over the last chunk. Two slots of pinned buffers
  take turns, and a slot is written again only after its `store` ran. On
  the CPU `store` gets the tensors themselves.
  """

  def __init__(self, device):
    self.device = torch.device(device)
    self.cuda = self.device.type == 'cuda'
    self._slots = [None, None]
    self._count = 0
    self._pending = None

  def dispatch(self, tensors, store):
    if self.cuda:
      k = self._count % 2
      self._count += 1
      slot = self._slots[k]
      if slot is None or any(
          h.numel() < t.numel() for h, t in zip(slot, tensors)):
        # Its last copy and store are done: it may be replaced.
        self._slots[k] = [torch.empty(t.numel(), pin_memory=True)
                          for t in tensors]
      host = [h[:t.numel()].view(t.shape)
              for h, t in zip(self._slots[k], tensors)]
      for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
      event = torch.cuda.Event()
      event.record(torch.cuda.current_stream(self.device))
    else:
      host, event = list(tensors), None
    previous, self._pending = self._pending, (event, host, store)
    if previous is not None:
      self._finish(previous)

  def drain(self):
    if self._pending is not None:
      previous, self._pending = self._pending, None
      self._finish(previous)

  @staticmethod
  def _finish(pending):
    event, host, store = pending
    if event is not None:
      event.synchronize()
    store(host)


def _stream_forecast_params(
    features, distribution, params_flat, config, chunk_size, backend, mesh,
    rows, with_count_means,
):
  """Pass 1: the forward chunk by chunk.

  Args:
    features: (N, D) float32 raw features on the host.
    distribution: observation model.
    params_flat: flat parameters (K leading) on the compute device.
    config: model config.
    chunk_size: rows of a forward chunk.
    backend: the resolved backend.
    mesh: None or a mesh (in one process or across ranks).
    rows: rows of a host chunk (`_resolve_rows`).
    with_count_means: count models: append the observation means as a
      per-row leaf (the public means of `predict_bnf_streamed`).

  Returns:
    (host, scalars, stats): host {leaf id: (K, N) CPU tensor} of the
    per-row leaves; scalars {leaf id: (K,) device tensor} of the per-member
    leaves; stats, the bracket statistics of all rows as device scalars.
  """
  n = features.shape[0]
  k = int(params_flat[0].shape[0])
  device = params_flat[0].device
  chunk = predict_lib.device_chunk_rows(chunk_size, mesh)
  with_count_means = bool(with_count_means) and distribution != NORMAL
  host, scalars, stats = {}, {}, None
  uploads = streaming_lib.HostUploads([(rows, features.shape[1])], device)
  fetches = _Fetches(device)
  for lo, hi in _chunk_ranges(n, rows):

    def fill(arrays, lo=lo, hi=hi):
      padded = -(-(hi - lo) // chunk) * chunk
      arrays[0][:hi - lo] = features[lo:hi]
      arrays[0][hi - lo:padded] = 0.0
      return padded

    upload = uploads.send(fill)
    (x,) = uploads.receive(upload)
    fp = predict_lib._forecast_params_chunked(  # pylint: disable=protected-access
        config, distribution, params_flat, field_lib.aug_features(config, x),
        chunk_size=chunk_size, backend=backend, mesh=mesh)
    uploads.release(upload)
    means, chunk_stats = predict_lib.summaries(distribution, fp, hi - lo)
    stats = chunk_stats if stats is None else predict_lib.fold_summaries(
        distribution, stats, chunk_stats)
    leaves = fp + (means,) if with_count_means else fp
    row_ids = []
    for i, leaf in enumerate(leaves):
      if leaf.ndim == 1:
        scalars.setdefault(i, leaf)  # The same in every chunk.
      else:
        row_ids.append(i)
        if i not in host:
          host[i] = torch.empty((k, n))

    def store(arrays, lo=lo, hi=hi, row_ids=row_ids):
      for i, a in zip(row_ids, arrays):
        host[i][:, lo:hi] = a[:, :hi - lo]

    fetches.dispatch([leaves[i] for i in row_ids], store)
  fetches.drain()
  return host, scalars, stats


def _prepare(features, params, config, ensemble_dims, backend, mesh,
             chunk_size, stream_chunk_rows):
  """`predict._prepare_predict_inputs` with the grid left on the host, and
  the host chunk's rows."""
  features, params_flat, ens_shape, backend, mesh = (
      predict_lib._prepare_predict_inputs(  # pylint: disable=protected-access
          features, params, config, ensemble_dims, backend, mesh,
          features_on_host=True))
  rows = _resolve_rows(stream_chunk_rows,
                       predict_lib.device_chunk_rows(chunk_size, mesh),
                       features.shape[0])
  return features, params_flat, ens_shape, backend, mesh, rows


def forecast_params_bnf_streamed(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    ensemble_dims: int = 2,
    chunk_size: int = 4096,
    backend: str = 'auto',
    mesh=None,
    stream_chunk_rows: int = 65536,
):
  """Host-streamed twin of `predict.forecast_params_bnf`.

  The same leaves (per-row `ensemble_shape + (N,)`, per-member
  `ensemble_shape`) as CPU tensors, bit for bit the in-memory ones, with
  device memory O(stream_chunk_rows).
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  features, params_flat, ens_shape, backend, mesh, rows = _prepare(
      features, params, config, ensemble_dims, backend, mesh, chunk_size,
      stream_chunk_rows)
  host, scalars, _ = _stream_forecast_params(
      features, distribution, params_flat, config, chunk_size, backend, mesh,
      rows, with_count_means=False)
  leaves = [host[i] if i in host else scalars[i].cpu()
            for i in range(len(host) + len(scalars))]
  return tuple(leaf.reshape(ens_shape + tuple(leaf.shape[1:]))
               for leaf in leaves)


def predict_bnf_streamed(
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
    stream_chunk_rows: int = 65536,
    stream_cache_bytes: int | None = None,
):
  """Host-streamed twin of `predict.predict_bnf` (the same arguments and
  results).

  The means (`ensemble_shape + (N,)`) and each quantile ((N,)) come back as
  CPU tensors, bit for bit the in-memory predict's (the approximate
  quantiles to within rounding), with device memory O(stream_chunk_rows).
  `stream_cache_bytes` is accepted for the JAX package's signature and
  ignored: nothing is cached on the device (module docstring).
  """
  del stream_cache_bytes
  distribution = likelihoods.LikelihoodDist(observation_model)
  features, params_flat, ens_shape, backend, mesh, rows = _prepare(
      features, params, config, ensemble_dims, backend, mesh, chunk_size,
      stream_chunk_rows)
  n = features.shape[0]
  k = int(params_flat[0].shape[0])
  quantiles = tuple(float(q) for q in quantiles)
  host, scalars, stats = _stream_forecast_params(
      features, distribution, params_flat, config, chunk_size, backend, mesh,
      rows, with_count_means=True)
  # The public means are NORMAL's locations or the count models' last leaf;
  # the search reads the other per-row leaves of `forecast_params`.
  means_id = max(host)
  means = host[means_id].reshape(ens_shape + (n,))
  if not quantiles:
    return means, []
  searched_ids = tuple(i for i in sorted(host)
                       if distribution == NORMAL or i != means_id)

  # Pass 2: the search chunk by chunk, uploads one chunk ahead.
  chunk = predict_lib.device_chunk_rows(chunk_size, mesh)
  uploads = streaming_lib.HostUploads([(k * rows,)] * len(searched_ids),
                                      params_flat[0].device)
  fetches = _Fetches(params_flat[0].device)
  ranges = list(_chunk_ranges(n, rows))
  q_out = torch.empty((len(quantiles), n))

  def start(ci):
    lo, hi = ranges[ci]
    padded = -(-(hi - lo) // chunk) * chunk

    def fill(arrays):
      for i, a in zip(searched_ids, arrays):
        block = a[:k * padded].reshape(k, padded)
        block[:, :hi - lo] = host[i][:, lo:hi].numpy()
        block[:, hi - lo:] = 0.0
      return k * padded

    return uploads.send(fill)

  upload = start(0)
  for ci, (lo, hi) in enumerate(ranges):
    current = upload
    upload = start(ci + 1) if ci + 1 < len(ranges) else None
    searched = dict(zip(searched_ids, (t.view(k, -1) for t in
                                       uploads.receive(current))))
    fp = tuple(scalars[i] if i in scalars else searched[i]
               for i in range(len(scalars) + len(searched)))
    q = predict_lib.quantile_rows(
        distribution, fp, ens_shape, quantiles, approximate_quantiles, stats,
        hi - lo)
    uploads.release(current)

    def store(arrays, lo=lo, hi=hi):
      q_out[:, lo:hi] = arrays[0]

    fetches.dispatch([q], store)
  fetches.drain()
  return means, list(q_out.unbind(0))
