"""Ensemble MAP / MLE trainer, on one device or over a mesh (counterpart of
`bayesnf_tpu/inference/map.py`).

- loss = -(loglik * N/B + prior_weight * prior_log_prob); MLE is
  prior_weight == 0.
- init: every member from `field.init_params`, drawn by one CPU
  `torch.Generator` seeded with the int `seed` (so a seed starts the same
  ensemble on every device); the noise scale starts at log(nanstd(y) / 2),
  computed in numpy as the JAX package computes it.
- Adam as optax computes it (`adam_update`), over leaves with a leading
  member axis E.
- Full batch (B == N): one step per epoch, whose recorded loss is the loss
  before its update. Minibatch (B < N): every epoch each member draws its
  own permutation of the rows, drops the ragged tail and takes N // B
  steps on its own batches; the epoch's loss is the mean of its steps'.
  Permutations come from a generator on the fit's device seeded from
  `seed` (`stream_seed`), so both backends see the same batches.
- Each step's losses and gradients come from one of two backends
  (`backends.py`): 'kernel' makes one `fused_mlp.fused_train` call over the
  step's rows (K1 on CUDA; per-member batches are (E, ., B) inputs); 'torch'
  runs autograd through `field.apply_field_t` and
  `likelihoods.log_likelihood` in `ROW_CHUNK`-row chunks, summed, as the
  JAX package's chunked gradient accumulation does. Both add the prior,
  in closed form (`_prior_losses_and_grads`), after the likelihood. The
  observation model is NORMAL, NB or ZINB on both.
- `fit_map` keeps the `num_splits` host loop over ensemble chunks.
- A mesh (`parallel/mesh.py`; in one process a device may repeat): the
  members, padded to a multiple of the 'ens' extent, split into groups,
  each on its row's first device; the rows go into the balanced layout of
  `parallel/minibatch.py`, data shard j of every group on the group's
  device j. Each step, every (group, shard) cell computes its members'
  likelihood losses and gradients on its rows (K1 with the shard's
  `n_valid` on 'kernel', 0/1 row weights on 'torch'); the shards' terms
  are moved to the group's first device and summed there in shard order
  (no atomics, no dependence on which device finishes first), then the
  prior is added once and Adam steps the group. A minibatch over several
  data shards draws batch_size / shards rows from each shard's own rows
  (`minibatch.local_permutation`), or, when the batch does not split evenly
  (the 'torch' backend only), the one-shard global permutation mapped into
  the stored layout. Without a mesh a fit runs on one device: a 1 x 1 mesh.
- A mesh across ranks (`parallel/distributed.py`): every rank draws the
  same init, permutations and noise, keeps only the groups and row shards
  of its own cells, and drives only those cells. A group whose shards live
  on several ranks gathers every shard's losses and gradients to each of
  its ranks (`distributed.exchange_shards`), where they are added in shard
  order as above, so every data rank of the group applies the same Adam
  update to its own replica, and each cell computes the bits of the
  single-process mesh of the same layout. The results are gathered on
  every rank.
- `precision` ('f32', 'highest' or 'bf16', `ops/mixed.py`) sets the
  products of both backends: on 'torch' every dense layer's product
  (`mixed.matmul_bf16` under 'bf16', as the JAX package's XLA path), on
  'kernel' K1's (as its TPU kernel). 'highest' is 'f32' bit for bit. The
  'torch' backend's fp32 products run in true fp32 whatever the caller set
  (`mixed.fp32_matmuls`).
- Checkpoints (`checkpoint_dir`, `utils/checkpoint.py`): the fit trains in
  chunks of `checkpoint_every` epochs and saves after each, the last one
  included, its parameters, Adam state, the states of its permutation
  generators, its losses and its epoch; a fit restarted on the directory
  resumes from the newest save, bit for bit the uninterrupted fit, and
  one that had finished returns its result without training. The
  fingerprint (`open_checkpointer`) holds the JAX package's fields, the
  resolved backend among them, and leaves `num_epochs` out, so a resume
  may extend the budget.
- Host streaming (`stream_chunk_steps`, `parallel/streaming.py`): the
  table stays on the host and each epoch's steps take the batches of one
  shared permutation (`stream_train`), sent to the card a slice at a
  time; every member reads a step's batch as K1's shared (D, B) input,
  or, with `stream_member_remix`, its own remix of the slice as (E, ., B)
  inputs. Over several data shards a step's batch splits evenly over
  them. The streamed fit's results do not depend on the slice size (but
  with remix, whose window it is).
- Spans (`utils/profiling.py`, while a profiler records): `train` is
  `bnf.fit`; each step, over every ensemble group, `bnf.fit.step`, and in
  it each group's batch gather `bnf.fit.batch`, loss and gradients
  `bnf.fit.loss` (K1's call inside it `bnf.k1`) and Adam `bnf.fit.adam`.
"""

from typing import NamedTuple

import numpy as np
import torch

from bayesnf_torch.inference import backends
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.models import priors
from bayesnf_torch.ops import fused_mlp
from bayesnf_torch.ops import mixed
from bayesnf_torch.parallel import distributed
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.parallel import minibatch as minibatch_lib
from bayesnf_torch.parallel import streaming as streaming_lib
from bayesnf_torch.utils import checkpoint as ckpt_lib
from bayesnf_torch.utils import profiling

# Rows per autograd chunk on the 'torch' backend (the JAX package's
# `grad_row_chunk`): one chunk's graph holds a few (E, width, ROW_CHUNK)
# activations instead of (E, width, N).
ROW_CHUNK = 8192
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
  """optax's ScaleByAdamState: step count, first and second moments."""

  count: int
  mu: tuple
  nu: tuple


def init_opt_state(params) -> AdamState:
  return AdamState(
      0,
      tuple(torch.zeros_like(p) for p in params),
      tuple(torch.zeros_like(p) for p in params),
  )


def _bias_correction(decay: float, count: int) -> float:
  """1 - decay**count in float32, as optax takes it."""
  return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def adam_update(grads, state: AdamState, learning_rate: float):
  """One optax.adam(learning_rate) update, written out elementwise.

  Returns:
    (updates, new state); the caller adds the updates to the parameters.
  """
  count = state.count + 1
  bc1 = _bias_correction(ADAM_B1, count)
  bc2 = _bias_correction(ADAM_B2, count)
  mu = tuple((1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, state.mu))
  nu = tuple(
      (1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, state.nu)
  )
  updates = tuple(
      -learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
      for m, v in zip(mu, nu)
  )
  return updates, AdamState(count, mu, nu)


def _prior_losses_and_grads(config, params, prior_weight):
  """-prior_weight * prior_log_prob per member, and its gradient, in closed
  form.

  Every leaf's prior is Logistic(loc, 1) elementwise, so with z = p - loc
  the gradient of the loss is w - 2w / (1 + e^z), evaluated op for op as
  autograd's backward of `priors.prior_log_prob` (w in float32), so it
  rounds alike. Autograd would run the backward of CUDA tensors on its
  device thread, whose graph task holds the gradients it returned until
  that thread lets it go, which may be after the step's next allocations:
  the closed form keeps every tensor of a step on the caller's thread.
  """
  weight = torch.full((), prior_weight, dtype=torch.float32,
                      device=params[0].device)
  grads = [weight - 2.0 * weight / (1 + torch.exp(p - spec.prior_loc))
           for spec, p in zip(field_lib.param_specs(config), params)]
  return -prior_weight * priors.prior_log_prob(config, params), grads


def make_nll_and_grads(config, distribution, lik_scale, backend,
                       precision='f32'):
  """The `(params, x_t, seasonal_t, y, n_valid=None, row_weights=None) ->
  (losses (E,), grads)` of `lik_scale * -loglik` on `backend` ('torch' or
  'kernel', resolved), its products at `precision`.

  x_t (D, B), seasonal_t (2F, B) and y (B,) are shared by every member, or
  grouped with a leading axis that divides E (`field.grouped`). With
  `n_valid` only the first `n_valid` rows count (a data shard of the
  balanced layout: K1's `n_valid` on 'kernel', 0/1 row weights on
  'torch'). 'torch' also takes per-member `row_weights` (E, B).
  """
  mixed.check_precision(precision)

  def torch_nll_and_grads(params, x_t, seasonal_t, y, n_valid=None,
                          row_weights=None):
    if n_valid is not None:
      row_weights = (torch.arange(y.shape[-1], device=y.device)
                     < n_valid).float()
    losses = torch.zeros_like(params[0]).reshape(-1)
    grads = [torch.zeros_like(p) for p in params]
    leaves = [p.detach().requires_grad_(True) for p in params]
    for lo in range(0, y.shape[-1], ROW_CHUNK):
      rows = slice(lo, lo + ROW_CHUNK)
      with torch.enable_grad(), mixed.fp32_matmuls():
        pred = field_lib.apply_field_t(
            config, leaves, x_t[..., rows], seasonal_t[..., rows], precision)
        chunk_losses = -lik_scale * likelihoods.log_likelihood(
            distribution, leaves, pred, y[..., rows],
            None if row_weights is None else row_weights[..., rows])
        # NORMAL leaves the NB/ZINB scalars out of the graph: zero grads.
        chunk_grads = torch.autograd.grad(
            chunk_losses.sum(), leaves, allow_unused=True,
            materialize_grads=True)
      losses = losses + chunk_losses.detach()
      grads = [g + cg for g, cg in zip(grads, chunk_grads)]
    return losses, grads

  def kernel_nll_and_grads(params, x_t, seasonal_t, y, n_valid=None,
                           row_weights=None):
    if row_weights is not None:
      raise ValueError(
          "K1 takes no row weights: a minibatch that does not split evenly "
          "over the data shards runs on backend='torch'.")
    weights, biases = field_lib.dense_params(config, params)
    obs_raw = torch.stack(
        [params[field_lib.IDX_LOG_NOISE_SCALE],
         params[field_lib.IDX_NB_SHAPE_RAW],
         params[field_lib.IDX_ZINB_LOGIT]], dim=-1)
    losses, dlsa, dfs, dws, dbs, dscales, dlogit, dobs = fused_mlp.fused_train(
        distribution.value, config.depth, lik_scale, config.input_scales,
        config.fourier_degrees, config.interactions, x_t, seasonal_t,
        weights, biases, params[field_lib.IDX_LOG_SCALE_ADJ],
        params[field_lib.IDX_FEATURE_SCALES],
        params[field_lib.IDX_LAYER_SCALES],
        params[field_lib.IDX_ACTIVATION_LOGIT], obs_raw, y,
        precision=precision, n_valid=n_valid,
    )
    return losses, field_lib.scatter_fused_train_grads(
        config, dlsa, dfs, dws, dbs, dscales, dlogit, dobs)

  if backend == 'kernel':
    return kernel_nll_and_grads
  if backend == 'torch':
    return torch_nll_and_grads
  raise ValueError(f'Unresolved backend: {backend!r}')


def as_shards(rows):
  """The row shards of a step function's `*rows`: one row set (x_t,
  seasonal_t, y) on the parameters' device, or one argument, a sequence of
  row shards (`sum_over_shards`)."""
  return rows[0] if len(rows) == 1 else (rows,)


def sum_over_shards(nll_and_grads, params, shards, exchange=None):
  """`nll_and_grads` of `params` summed over row shards.

  Each shard is the arguments after `params` of one call (x_t, seasonal_t,
  y[, n_valid[, row_weights]]), all on one device: the parameters go there, and
  the shard's losses and gradients come back to the parameters' device and
  are added in shard order, so the sum does not depend on which device
  finishes first. One shard on the parameters' device is one plain call.
  Across ranks (`exchange`, from `distributed.shard_exchange`) the shards
  of the other ranks are None here and `exchange` fetches their results
  from them before the sum, which is then the same on every rank of the
  group.
  """
  home = params[0].device
  results = []
  for shard in shards:
    if shard is None:
      results.append(None)
      continue
    local = tuple(p.to(shard[2].device) for p in params)
    losses, grads = nll_and_grads(local, *shard)
    results.append((losses.to(home), [g.to(home) for g in grads]))
  if exchange is not None:
    results = exchange(results)
  total = None
  for losses, grads in results:
    total = (losses, grads) if total is None else (
        total[0] + losses, [a + b for a, b in zip(total[1], grads)])
  return total


def make_losses_and_grads(config, distribution, prior_weight, backend,
                          lik_scale=1.0, precision='f32'):
  """The per-step `(params, *rows) -> (losses (E,), grads)` of a fit on
  `backend` ('torch' or 'kernel', resolved): `lik_scale` (N / B) times the
  negative log-likelihood of the step's rows (`make_nll_and_grads`, at
  `precision`), plus the prior, added once after the rows' sum. `rows`
  (`as_shards`) is x_t, seasonal_t and y, shared (D, B) or per member
  (E, D, B), or a sequence of row shards; `exchange` as for
  `sum_over_shards`."""
  nll_and_grads = make_nll_and_grads(config, distribution, lik_scale, backend,
                                     precision)

  def losses_and_grads(params, *rows, exchange=None):
    losses, grads = sum_over_shards(nll_and_grads, params, as_shards(rows),
                                    exchange)
    if prior_weight != 0.0:
      prior_losses, prior_grads = _prior_losses_and_grads(
          config, params, prior_weight)
      losses = losses + prior_losses
      grads = [g + pg for g, pg in zip(grads, prior_grads)]
    return losses, grads

  return losses_and_grads


def gather_batch(x_t, seasonal_t, y, idx):
  """Per-member batches of the rows `idx` (E, B): (E, D, B), (E, 2F, B) and
  (E, B), contiguous, as K1 reads them."""
  return (x_t[:, idx].transpose(0, 1).contiguous(),
          seasonal_t[:, idx].transpose(0, 1).contiguous(), y[idx])


def random_permutations(generator, members, n):
  """(members, n): an independent permutation of range(n) per member, from
  one draw of `generator` (one launch, not one `randperm` per member)."""
  return torch.argsort(
      torch.rand((members, n), generator=generator,
                 device=generator.device), dim=1)


def check_batch_split(backend, batch_size, data_size, data_shards):
  """Raises ValueError for the kernel path of a minibatch that does not
  split evenly over `data_shards` (the JAX package's refusal)."""
  if (backend == 'kernel' and data_shards > 1 and batch_size < data_size
      and batch_size % data_shards):
    raise ValueError(
        f'minibatch training over a sharded data axis requires '
        f'batch_size % data_shards == 0 (got {batch_size=}, '
        f'{data_shards=}): each shard contributes batch_size/data_shards '
        "rows per step. Adjust batch_size or use backend='torch' (global-"
        'permutation fallback).'
    )


def batch_rows(rows, data_size, batch_size, perms, group_size):
  """The `(group, step) -> row shards` of one epoch over the shard layout
  `rows` (`minibatch.shard_rows`) with the epoch's `perms` (see `train`):
  the whole shards for a full batch, else each step's per-member batches of
  `batch_size` rows, gathered on the shards' devices; None for a cell of
  another rank."""
  shards = len(rows[0])
  if batch_size == data_size:
    return lambda i, k: rows[i]

  def members(t, i):
    return t[i * group_size:(i + 1) * group_size]

  if shards > 1 and batch_size % shards == 0:
    local = batch_size // shards

    def local_batch(i, k):
      return [None if r is None else gather_batch(
          r.x_t, r.seasonal_t, r.y,
          members(p, i)[:, k * local:(k + 1) * local].to(r.y.device))
              for r, p in zip(rows[i], perms)]

    return local_batch
  keep = perms[:, : data_size // batch_size * batch_size]
  if shards == 1:

    def global_batch(i, k):
      r = rows[i][0]
      return [gather_batch(r.x_t, r.seasonal_t, r.y, members(
          keep, i)[:, k * batch_size:(k + 1) * batch_size].to(r.y.device))]

    return global_batch
  # A global batch over several shards: each shard gathers the batch's
  # stored positions it holds, and the others weigh 0.
  local_rows = minibatch_lib.shard_counts(data_size, shards)[0]
  stored = torch.as_tensor(minibatch_lib.stored_positions(
      data_size, shards), device=keep.device)[keep]

  def spread_batch(i, k):
    pos = members(stored, i)[:, k * batch_size:(k + 1) * batch_size]
    out = []
    for j, r in enumerate(rows[i]):
      if r is None:
        out.append(None)
        continue
      at = (pos - j * local_rows).to(r.y.device)
      held = (at >= 0) & (at < local_rows)
      out.append((*gather_batch(r.x_t, r.seasonal_t, r.y,
                                at.clamp(0, local_rows - 1)),
                  None, held.float()))
    return out

  return spread_batch


def split_groups(leaves, mesh):
  """Leaves with a leading member axis E split into the mesh's ensemble
  groups: group i, members [i E / ens, (i + 1) E / ens), on `mesh.home(i)`
  (the first device of row i in one process); across ranks None for a
  group of which this rank holds no cell (`distributed.make_global`).

  Raises:
    ValueError: if E is not a multiple of the 'ens' extent.
  """
  blocks = [distributed.make_global(t, mesh) for t in leaves]
  return [None if parts[0] is None else tuple(parts)
          for parts in zip(*blocks)]


def gather_groups(groups, device, mesh=None):
  """`split_groups` undone: each leaf's groups joined on `device` (one
  group: its leaves as they are); over a mesh across ranks, every group
  gathered to every rank first, group i from the rank of cell (i, 0)."""
  if mesh is not None and mesh.is_multiprocess:
    groups = distributed.host_leaves(groups, [row[0] for row in mesh.ranks],
                                     device)
  return tuple(parts[0] if len(parts) == 1 else
               torch.cat([t.to(device) for t in parts])
               for parts in zip(*groups))


def split_state(opt_state: AdamState, mesh) -> list:
  """`opt_state`'s moments split as `split_groups` splits the parameters:
  one `AdamState` a group (None for another rank's)."""
  return [None if mu is None else AdamState(opt_state.count, mu, nu)
          for mu, nu in zip(split_groups(opt_state.mu, mesh),
                            split_groups(opt_state.nu, mesh))]


def gather_state(groups, states, mesh):
  """(leaves, `AdamState`) of every group joined on the mesh's first device
  (`gather_groups`, one gather of the leaves and both moments)."""
  joined = [None if g is None else (*g, *s.mu, *s.nu)
            for g, s in zip(groups, states)]
  leaves = gather_groups(joined, mesh.first_device, mesh)
  num = len(leaves) // 3
  count = next(s for s in states if s is not None).count
  return leaves[:num], AdamState(count, leaves[num:2 * num],
                                 leaves[2 * num:])


def gather_losses(history, mesh, members):
  """(members, T) losses on the mesh's first device from each group's list
  of T (group size,) losses (None for another rank's group)."""
  if not any(history):
    return torch.zeros((members, 0), device=mesh.first_device)
  return gather_groups(
      [None if h is None else (torch.stack(h, dim=1),) for h in history],
      mesh.first_device, mesh)[0]


def train(
    params,
    opt_state: AdamState,
    aug_t: torch.Tensor,
    target: torch.Tensor,
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    learning_rate: float,
    num_epochs: int,
    prior_weight: float = 1.0,
    backend: str = 'torch',
    batch_size: int | None = None,
    permutations=None,
    precision: str = 'f32',
    mesh=None,
):
  """`num_epochs` Adam epochs from `params` and `opt_state`, on one device or
  over `mesh`.

  Args:
    params: flat parameter tuple, each leaf with a leading member axis E (a
      multiple of the mesh's 'ens' extent).
    opt_state: Adam state of `params` (`init_opt_state` for a new fit).
    aug_t: (D + 2F, N) inputs with seasonal features, features-major.
    target: (N,) targets.
    config: model config.
    distribution: observation model.
    learning_rate: Adam learning rate.
    num_epochs: epochs.
    prior_weight: prior multiplier (0 == MLE).
    backend: 'torch' or 'kernel' (resolved).
    batch_size: None or N (one full-batch step per epoch), or B < N.
    permutations: with B < N, a function `epoch -> ` the epoch's rows:
      (E, N) row permutations, of which each member takes the first
      N // B * B (one data shard, or a batch that does not split evenly
      over several); with several data shards and B % shards == 0, a list
      over the shards of (E, N // B * B / shards) positions among each
      shard's valid rows (`minibatch.local_permutations`). Fits draw them
      from seeded generators; tests give the JAX package's.
    precision: 'f32' | 'highest' | 'bf16' (`make_nll_and_grads`).
    mesh: a `parallel.mesh.Mesh`, or None: one device, that of `target`.

  Returns:
    (params, opt_state, losses) on the mesh's first device (on every rank
    of a mesh across ranks): losses (E, num_epochs), each epoch's loss
    before its update (full batch) or the mean of its steps' losses
    (minibatch).

  Raises:
    ValueError: if E does not split into the mesh's ensemble groups, or
      for 'kernel' with a minibatch that does not split evenly over the
      data shards.
  """
  with profiling.span('bnf.fit'):
    mesh = fit_mesh(mesh, target.device)
    n = target.shape[0]
    batch_size = n if batch_size is None else min(int(batch_size), n)
    check_batch_split(backend, batch_size, n,
                      mesh.shape[mesh_lib.DATA_AXIS])
    losses_and_grads = make_losses_and_grads(
        config, distribution, prior_weight, backend,
        lik_scale=n / batch_size, precision=precision)
    rows = minibatch_lib.shard_rows(aug_t, target, mesh, config.num_inputs)
    members = params[0].shape[0]
    params = split_groups(params, mesh)
    states = split_state(opt_state, mesh)
    size = members // len(params)
    num_batches = n // batch_size
    history = [None if p is None else [] for p in params]
    for epoch in range(int(num_epochs)):
      batch = batch_rows(rows, n, batch_size, None if batch_size == n
                         else permutations(epoch), size)
      step_losses = [[] for _ in params]
      for k in range(num_batches):
        with profiling.span('bnf.fit.step'):
          for i, state in enumerate(states):
            if state is None:
              continue
            with profiling.span('bnf.fit.batch'):
              rows_ik = batch(i, k)
            with profiling.span('bnf.fit.loss'):
              losses, grads = losses_and_grads(
                  params[i], rows_ik,
                  exchange=distributed.shard_exchange(mesh, i))
            with profiling.span('bnf.fit.adam'):
              updates, states[i] = adam_update(grads, state, learning_rate)
              params[i] = tuple(p + u for p, u in zip(params[i], updates))
            step_losses[i].append(losses)
      for i, group in enumerate(step_losses):
        if group:
          history[i].append(group[0] if num_batches == 1 else
                            torch.stack(group).mean(dim=0))
    params, opt_state = gather_state(params, states, mesh)
    return params, opt_state, gather_losses(history, mesh, members)


def init_ensemble(config, ensemble_size, seed: int, log_noise_init, device):
  """`ensemble_size` members from `field.init_params`, drawn in order by one
  CPU generator seeded with `seed`, then moved to `device`."""
  generator = torch.Generator().manual_seed(int(seed))
  members = [
      field_lib.init_params(config, generator, 'cpu', log_noise_init)
      for _ in range(ensemble_size)
  ]
  return tuple(
      torch.stack(leaves).to(device) for leaves in zip(*members)
  )


def check_supported(batch_size, data_size, data_shards,
                    stream_chunk_steps=None,
                    stream_member_remix=False) -> bool:
  """The JAX package's checks of the streaming arguments; returns whether
  the fit streams.

  Raises:
    ValueError: for a slice of fewer than one step, a streamed full batch,
      a streamed batch that does not split evenly over the data shards, or
      a remix without streaming.
  """
  if stream_chunk_steps is None:
    if stream_member_remix:
      raise ValueError(
          'stream_member_remix applies to host-streaming fits only '
          '(set stream_chunk_steps); on-device minibatch training already '
          'permutes per member.')
    return False
  if int(stream_chunk_steps) < 1:
    raise ValueError(f'{stream_chunk_steps=} must be a positive int.')
  if batch_size == data_size:
    raise ValueError(
        'stream_chunk_steps requires minibatch training (batch_size < '
        'len(table)): a full-batch fit re-reads the whole dataset every '
        'step, which defeats streaming — set batch_size or drop the flag.')
  if batch_size % data_shards:
    raise ValueError(
        f'streaming training over a sharded data axis requires '
        f'batch_size % data_shards == 0 (got {batch_size=}, '
        f'{data_shards=}): each slice batch splits evenly over shards.')
  return True


def fit_mesh(mesh, device):
  """The mesh of a fit: `mesh` itself, or one `device` (a 1 x 1 mesh).
  Across ranks, the process groups of its rows are made here, where every
  rank enters (`distributed.row_groups`).

  Raises:
    TypeError: if `mesh` is not a `parallel.mesh.Mesh`.
  """
  if mesh is None:
    return mesh_lib.Mesh([[device]])
  mesh = mesh_lib.check_mesh(mesh)
  if mesh.is_multiprocess:
    distributed.row_groups(mesh)
  return mesh


def resolve_fit_backend(backend, mesh, config, distribution, batch_size,
                        data_size):
  """`backends.resolve_backend` for a fit of `distribution` over `mesh`."""
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  return backends.resolve_backend(
      backend, mesh.device_type, config,
      likelihoods.LikelihoodDist(distribution).value, data_shards=shards,
      full_batch=batch_size == data_size,
      batch_divisible=batch_size % shards == 0)


class SeededPermutations:
  """The `permutations` of a minibatch MAP fit (see `train`), drawn on the
  mesh's first device (every rank of a mesh across ranks draws them all,
  so each cell reads what it reads in one process), each member from a
  generator of its own: every
  epoch member m's permutation of the rows from `stream_seed(seed,
  PERMUTATION_STREAM, m)`, or, with a batch that splits evenly over several
  data shards, its local permutation of shard j from `stream_seed(seed,
  PERMUTATION_STREAM, m, j)` (an RNG deviation from the JAX package, which
  folds the shard into each member's key). A member's batches do not depend
  on how many members an ensemble is padded to.

  Attributes:
    generators: every generator drawn from, in a fixed order; their states
      go into a fit's checkpoints.
  """

  def __init__(self, seed, members, data_size, batch_size, mesh):
    device = mesh.first_device
    shards = mesh.shape[mesh_lib.DATA_AXIS]
    self._device = device
    self._local = shards > 1 and batch_size % shards == 0
    if self._local:
      self._local_rows, self._counts = minibatch_lib.shard_counts(
          data_size, shards)
      self._count = data_size // batch_size * (batch_size // shards)
      keys = [(j,) for j in range(shards)]
    else:
      self._local_rows = data_size
      keys = [()]
    self._per_key = [[torch.Generator(device=device).manual_seed(
        stream_seed(seed, PERMUTATION_STREAM, m, *key))
                      for m in range(members)] for key in keys]
    self.generators = [g for gens in self._per_key for g in gens]

  def _uniforms(self, generators):
    return torch.stack([
        torch.rand(self._local_rows, generator=g, device=self._device)
        for g in generators])

  def __call__(self, epoch):
    del epoch  # each call draws the next epoch's permutations
    if self._local:
      return [minibatch_lib.local_permutation(self._uniforms(gens), n_s,
                                              self._count)
              for gens, n_s in zip(self._per_key, self._counts)]
    return torch.argsort(self._uniforms(self._per_key[0]), dim=1)


def local_shards(mesh) -> list[int]:
  """The data shards of this rank's cells, in order (every shard in one
  process)."""
  return sorted({j for _, j in mesh.local_cells})


def stream_columns(mesh, batch_size):
  """The positions within a step's batch of this rank's data shards
  (`local_shards`; step k's batch splits into equal column blocks over the
  shards), or None when this rank holds every shard."""
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  mine = local_shards(mesh)
  if len(mine) == shards:
    return None
  local = batch_size // shards
  return np.concatenate([np.arange(j * local, (j + 1) * local)
                         for j in mine])


def stream_batches(aug_s, y_s, num_inputs, mesh, group_size, remix=None):
  """The `(group, step) -> row shards` of one streamed slice (see `train`'s
  `batch_rows`).

  Args:
    aug_s: (S, D + 2F, B') inputs of the slice's S steps: the columns of
      this rank's data shards (`stream_columns`), B' = B in one process.
    y_s: (S, B') targets.
    num_inputs: D.
    mesh: the fit's mesh; step k's batch splits into equal column blocks
      over its data shards, block j on the group's device j (None for a
      cell of another rank).
    group_size: members a group.
    remix: None, every member the step's batch as shared (D, B) rows; or
      (S, E, B / shards) positions (`streaming.remix_indices`) into each
      shard's pool of the slice's rows, the per-member batches gathered as
      (E, ., B / shards) inputs.
  """
  mine = local_shards(mesh)
  local = aug_s.shape[-1] // len(mine)
  pieces = {j: (aug_s[..., p * local:(p + 1) * local],
                y_s[..., p * local:(p + 1) * local])
            for p, j in enumerate(mine)}
  if remix is not None:
    pools = {j: streaming_lib.remix_pool(a, y) for j, (a, y) in pieces.items()}

  def batch(i, k):
    out = []
    for j, dev in enumerate(mesh.devices[i]):
      if not mesh.is_local(i, j):
        out.append(None)
      elif remix is None:
        a = pieces[j][0][k].to(dev).contiguous()
        y = pieces[j][1][k].to(dev).contiguous()
        out.append((a[:num_inputs], a[num_inputs:], y))
      else:
        pool_aug, pool_y = pools[j]
        idx = remix[k, i * group_size:(i + 1) * group_size]
        out.append(tuple(t.to(dev) for t in gather_batch(
            pool_aug[:num_inputs], pool_aug[num_inputs:], pool_y, idx)))
    return out

  return batch


def slice_remix(remix_seed, slice_step, steps, members, rows, device):
  """The member remix of the slice starting at `slice_step`
  (`streaming.remix_indices`), or None without a `remix_seed`."""
  if remix_seed is None:
    return None
  return streaming_lib.remix_indices(
      [stream_seed(remix_seed, REMIX_STREAM, slice_step, m)
       for m in range(members)], steps, rows, device)


def stream_train(
    params,
    opt_state: AdamState,
    stream: streaming_lib.HostBatchStream,
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    learning_rate: float,
    num_epochs: int,
    prior_weight: float = 1.0,
    backend: str = 'torch',
    precision: str = 'f32',
    mesh=None,
    slice_steps: int = 1,
    start_epoch: int = 0,
    checkpoint_every: int | None = None,
    on_chunk=None,
    remix_seed: int | None = None,
):
  """Epochs `start_epoch` to `num_epochs` of a streamed fit, on one device
  or over `mesh` (see `train`).

  Every epoch takes `stream.num_batches` steps on the batches of `stream`
  (`parallel/streaming.py`), sent to the mesh's first device `slice_steps`
  steps at a time (`streaming.run_stream_driver`); across ranks each rank
  builds the same slices and sends only its data shards' columns
  (`stream_columns`) to its first device.

  Args:
    params, opt_state, config, distribution, learning_rate, prior_weight,
      backend, precision, mesh: as for `train`.
    stream: the host batch stream (`per_step_resample` False).
    num_epochs: the fit's total epochs.
    slice_steps: steps a slice (with remix, the remix window).
    start_epoch: the first epoch (a resumed fit's).
    checkpoint_every: epochs a chunk, or None (one chunk).
    on_chunk: None, or `(params, opt_state, losses, epochs_done)` after each
      chunk, with the chunk's losses (E, chunk epochs), all on the mesh's
      first device (gathered on every rank).
    remix_seed: None (the shared stream), or the fit's seed: each member
      remixes each slice (`slice_remix`).

  Returns:
    (params, opt_state, losses) on the mesh's first device: losses
    (E, num_epochs - start_epoch), the mean of each epoch's step losses.
  """
  mesh = fit_mesh(mesh, params[0].device)
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  num_batches = stream.num_batches
  check_batch_split(backend, stream.batch_size, stream.data_size, shards)
  losses_and_grads = make_losses_and_grads(
      config, distribution, prior_weight, backend,
      lik_scale=stream.data_size / stream.batch_size, precision=precision)
  members = params[0].shape[0]
  first = mesh.first_device
  groups = split_groups(params, mesh)
  states = split_state(opt_state, mesh)
  size = members // len(groups)
  history = []

  def run_slice(state, aug_s, y_s, slice_step):
    groups, states = state
    steps = aug_s.shape[0]
    batch = stream_batches(
        aug_s, y_s, config.num_inputs, mesh, size,
        slice_remix(remix_seed, slice_step, steps, members,
                    stream.batch_size // shards, first))
    losses = []
    for k in range(steps):
      step_losses = [None] * len(states)
      for i, group_state in enumerate(states):
        if group_state is None:
          continue
        step_losses[i], grads = losses_and_grads(
            groups[i], batch(i, k),
            exchange=distributed.shard_exchange(mesh, i))
        updates, states[i] = adam_update(grads, group_state, learning_rate)
        groups[i] = tuple(p + u for p, u in zip(groups[i], updates))
      losses.append(step_losses)
    return state, losses

  def chunk_done(state, step_losses, steps_done):
    step_losses = gather_step_losses(step_losses, mesh, members)
    epoch_losses = torch.stack([
        torch.stack(step_losses[e:e + num_batches]).mean(dim=0)
        for e in range(0, len(step_losses), num_batches)], dim=1)
    history.append(epoch_losses)
    if on_chunk is not None:
      on_chunk(*gather_state(*state, mesh), epoch_losses,
               steps_done // num_batches)

  groups, states = streaming_lib.run_stream_driver(
      stream, device=first, run_slice=run_slice, state=(groups, states),
      start_step=start_epoch * num_batches,
      num_steps=int(num_epochs) * num_batches, slice_steps=int(slice_steps),
      checkpoint_steps=(None if checkpoint_every is None
                        else checkpoint_every * num_batches),
      on_chunk=chunk_done, columns=stream_columns(mesh, stream.batch_size))
  losses = (torch.cat(history, dim=1) if history
            else torch.zeros((members, 0), device=first))
  return (*gather_state(groups, states, mesh), losses)


def gather_step_losses(step_losses, mesh, members):
  """A chunk's losses as one (E,) tensor a step on the mesh's first device,
  from a list a step of each group's losses (None for another rank's
  group), gathered once."""
  history = [None if group is None else [s[i] for s in step_losses]
             for i, group in enumerate(step_losses[0])]
  return list(gather_losses(history, mesh, members).unbind(1))


def host_rows(aug_features, target):
  """A streamed fit's table on the host: (D + 2F, N) float32 inputs, the
  transposed view of `aug_features` (numpy, a memmap or a tensor), and (N,)
  float32 targets."""
  if isinstance(aug_features, torch.Tensor):
    aug_features = aug_features.detach().cpu().numpy()
  return (np.asarray(aug_features, dtype=np.float32).T,
          np.asarray(target, dtype=np.float32))


def open_checkpointer(checkpoint_dir, checkpoint_every, total, streaming,
                      stream_member_remix, stream_chunk_steps, mesh,
                      **fields):
  """(checkpointer, newest saved state or None, epochs or steps a chunk) of
  a fit of `total` epochs or steps whose fingerprint holds `fields` and
  `stream`, and the remix keys only when remix is on (with the digest that
  always held them accepted otherwise, as the JAX package does); a chunk
  is `checkpoint_every`, by default total // 10 but at least 1. (None,
  None, None) without a `checkpoint_dir`: the fit is one chunk. Over a
  `mesh` across ranks the lowest rank writes and every rank restores.

  Raises:
    ValueError: for a `checkpoint_every` below 1, a remote URI, or a
      directory of another fit.
  """
  if checkpoint_dir is None:
    return None, None, None
  if checkpoint_every is None:
    checkpoint_every = max(1, int(total) // 10)
  elif int(checkpoint_every) < 1:
    raise ValueError(f'{checkpoint_every=} must be a positive int.')
  fields['stream'] = streaming
  if streaming and stream_member_remix:
    fields.update(stream_remix=True,
                  stream_remix_window=int(stream_chunk_steps))
    legacy = ()
  else:
    legacy = (ckpt_lib.run_fingerprint(
        **fields, stream_remix=False, stream_remix_window=None),)
  across = mesh.is_multiprocess
  checkpointer = ckpt_lib.TrainCheckpointer(
      checkpoint_dir, fingerprint=ckpt_lib.run_fingerprint(**fields),
      legacy_fingerprints=legacy,
      writer=not across or mesh.rank == min(r for row in mesh.ranks
                                            for r in row),
      barrier=distributed.barrier if across else None)
  return checkpointer, checkpointer.restore_latest(), int(checkpoint_every)


def ensemble_map(
    aug_features,
    target,
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    ensemble_size: int,
    learning_rate: float,
    num_epochs: int,
    seed: int,
    batch_size: int | None = None,
    prior_weight: float = 1.0,
    backend: str = 'auto',
    device='cuda',
    precision: str = 'f32',
    mesh=None,
    checkpoint_dir=None,
    checkpoint_every: int | None = None,
    stream_chunk_steps: int | None = None,
    stream_member_remix: bool = False,
):
  """Train `ensemble_size` independent MAP/MLE members.

  Args:
    aug_features: (N, D + 2F) training inputs with seasonal features
      appended (`field.aug_features`), numpy or a tensor; for a streamed
      fit numpy or an `np.memmap` (`field.aug_features_host`), which stays
      on the host.
    target: (N,) training targets (numpy).
    config: model config.
    distribution: observation model.
    ensemble_size: members to train.
    learning_rate: Adam learning rate.
    num_epochs: epochs (N // batch_size steps each).
    seed: int seed of the initialization, of the minibatch permutations
      (`SeededPermutations`) and of a streamed fit's batches
      (`stream_seed(seed, HOST_STREAM)`) and remix.
    batch_size: None or N (full batch), or B < N rows per step.
    prior_weight: prior multiplier (0 == MLE).
    backend: 'auto' | 'torch' | 'kernel' (`backends.resolve_backend`).
    device: where the fit runs without a mesh.
    precision: 'f32' | 'highest' (the same, bit for bit) | 'bf16'
      (`make_nll_and_grads`).
    mesh: None, or a `parallel.mesh.Mesh` to fit over (`train`); the
      members are padded to a multiple of its 'ens' extent, drawn in order
      (the first `ensemble_size` are the meshless fit's), and the padding
      is dropped on the way out.
    checkpoint_dir: None, or a local directory: the fit trains in chunks
      of `checkpoint_every` epochs, saves after each (`utils/checkpoint.py`)
      and resumes from the newest save found there, bit for bit.
    checkpoint_every: epochs a checkpoint chunk (default: num_epochs // 10,
      at least 1).
    stream_chunk_steps: None, or streamed training (minibatch fits only):
      the table stays on the host and the batches go to the device in
      slices of this many steps (`stream_train`).
    stream_member_remix: (streaming only) each member remixes each slice's
      rows into its own batches; `stream_chunk_steps` is then the remix
      window, and checkpoint chunks must be whole windows.

  Returns:
    (params, losses): params with leading member axis (ensemble_size, ...)
    on `device` (with a mesh, its first device); losses (ensemble_size,
    num_epochs) as numpy.

  Raises:
    ValueError: for the streaming arguments `check_supported`
      refuses, a remix misaligned with the checkpoint chunks, or a
      checkpoint directory that is remote or holds another fit.
  """
  target_np = np.asarray(target)
  mesh = fit_mesh(mesh, device)
  n = target_np.shape[0]
  batch_size = n if batch_size is None else min(int(batch_size), n)
  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  streaming = check_supported(batch_size, n, data_shards,
                              stream_chunk_steps, stream_member_remix)
  backend = resolve_fit_backend(backend, mesh, config, distribution,
                                batch_size, n)
  distribution = likelihoods.LikelihoodDist(distribution)
  num_epochs = int(num_epochs)
  padded = mesh_lib.pad_ensemble_size(ensemble_size, mesh)
  first = mesh.first_device
  log_noise_init = np.log(np.nanstd(target_np) / 2.0)
  params = init_ensemble(
      config, padded, seed, float(np.float32(log_noise_init)), first)
  opt_state = init_opt_state(params)
  permutations = (None if streaming or batch_size == n else
                  SeededPermutations(seed, padded, n, batch_size, mesh))
  generators = () if permutations is None else permutations.generators
  checkpointer, restored, checkpoint_every = open_checkpointer(
      checkpoint_dir, checkpoint_every, num_epochs, streaming,
      stream_member_remix, stream_chunk_steps, mesh, kind='map',
      config=config,
      distribution=distribution.value, ensemble_size=ensemble_size,
      learning_rate=float(learning_rate),
      batch_size=int(batch_size), data_size=n,
      prior_weight=float(prior_weight), precision=precision,
      backend=backend, data_shards=data_shards)
  epoch, loss_chunks = 0, []
  if restored is not None:
    params, (count, mu, nu) = restored.place(first)
    opt_state = AdamState(count, mu, nu)
    restored.restore_generators(generators)
    loss_chunks = [t.to(first) for t in restored.losses]
    epoch = restored.epoch

  def save(params, opt_state, epochs_done):
    if checkpointer is not None:
      checkpointer.save(ckpt_lib.TrainState.from_fit(
          params, opt_state, generators, loss_chunks, epochs_done))

  if streaming:
    aug_t, y = host_rows(aug_features, target_np)
    stream = streaming_lib.HostBatchStream(
        aug_t, y, batch_size, (stream_seed(seed, HOST_STREAM),))
    if stream_member_remix:
      streaming_lib.validate_remix_alignment(
          int(stream_chunk_steps), epoch * stream.num_batches,
          None if checkpoint_every is None
          else checkpoint_every * stream.num_batches)

    def on_chunk(params, opt_state, losses, epochs_done):
      loss_chunks.append(losses)
      save(params, opt_state, epochs_done)

    params, opt_state, _ = stream_train(
        params, opt_state, stream, config, distribution, learning_rate,
        num_epochs, prior_weight=prior_weight, backend=backend,
        precision=precision, mesh=mesh, slice_steps=int(stream_chunk_steps),
        start_epoch=epoch, checkpoint_every=checkpoint_every,
        on_chunk=on_chunk,
        remix_seed=seed if stream_member_remix else None)
  else:
    aug_t = torch.as_tensor(
        aug_features, dtype=torch.float32, device=first).T.contiguous()
    y = torch.tensor(target_np, dtype=torch.float32, device=first)
    while epoch < num_epochs:
      chunk = (num_epochs - epoch if checkpoint_every is None
               else min(checkpoint_every, num_epochs - epoch))
      params, opt_state, losses = train(
          params, opt_state, aug_t, y, config, distribution, learning_rate,
          chunk, prior_weight=prior_weight, backend=backend,
          batch_size=batch_size, permutations=permutations,
          precision=precision, mesh=mesh)
      loss_chunks.append(losses)
      epoch += chunk
      # The last chunk is saved too: a finished fit run again is a no-op.
      save(params, opt_state, epoch)
  losses = (torch.cat(loss_chunks, dim=1) if loss_chunks
            else torch.zeros((padded, 0), device=first))
  return (tuple(p[:ensemble_size] for p in params),
          losses[:ensemble_size].cpu().numpy())


# Keys of the random streams a fit derives from its int seed (the
# initialization uses the seed itself).
PERMUTATION_STREAM = 1
VI_STEP_STREAM = 2
# The CLI's CRPS draws (`cli/evaluate.py`).
CRPS_STREAM = 3
# A streamed fit's batch schedule (its `HostBatchStream` entropy), and its
# member remix (`slice_remix`).
HOST_STREAM = 4
REMIX_STREAM = 5


def stream_seed(seed: int, stream: int, *key: int) -> int:
  """A 63-bit seed for random stream `stream` of `seed` (and, within it,
  `key`, such as a data shard): the first word of numpy's
  SeedSequence(seed, spawn_key=(stream, *key))."""
  state = np.random.SeedSequence(int(seed), spawn_key=(int(stream), *key))
  return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def split_seed(seed: int, index: int, num_splits: int) -> int:
  """The seed of split `index`: `seed` itself for one split, otherwise the
  first 63-bit word of numpy's SeedSequence((seed, index)). (The JAX package
  folds `index` into its key with `jax.random.fold_in`, which torch cannot
  reproduce.)"""
  if num_splits == 1:
    return int(seed)
  state = np.random.SeedSequence((int(seed), int(index))).generate_state(
      1, np.uint64)
  return int(state[0] >> np.uint64(1))


def fit_map(
    aug_features,
    target,
    seed: int,
    observation_model: str,
    config: field_lib.FieldConfig,
    num_particles: int,
    learning_rate: float,
    num_epochs: int,
    prior_weight: float = 1.0,
    batch_size: int | None = None,
    num_splits: int = 1,
    backend: str = 'auto',
    device='cuda',
    precision: str = 'f32',
    mesh=None,
    checkpoint_dir=None,
    checkpoint_every: int | None = None,
    stream_chunk_steps: int | None = None,
    stream_member_remix: bool = False,
):
  """Fit a MAP/MLE ensemble in `num_splits` sequential splits, each over
  `mesh` if one is given (`ensemble_map`); with a `checkpoint_dir`, split
  i checkpoints into `{checkpoint_dir}/split_{i}`.

  Returns:
    (params, losses): params leaves (num_particles, ...) on `device` (with
    a mesh, its first device), losses (num_particles, num_epochs) as numpy.
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  if num_particles % num_splits != 0:
    raise ValueError(
        f'{num_particles=} must be divisible by {num_splits=}.'
    )
  per_split = num_particles // num_splits
  params_splits, losses_splits = [], []
  for i in range(num_splits):
    params_i, losses_i = ensemble_map(
        aug_features, target, config, distribution,
        ensemble_size=per_split, learning_rate=learning_rate,
        num_epochs=num_epochs, seed=split_seed(seed, i, num_splits),
        batch_size=batch_size, prior_weight=prior_weight, backend=backend,
        device=device, precision=precision, mesh=mesh,
        checkpoint_dir=(None if checkpoint_dir is None
                        else f'{checkpoint_dir}/split_{i}'),
        checkpoint_every=checkpoint_every,
        stream_chunk_steps=stream_chunk_steps,
        stream_member_remix=stream_member_remix,
    )
    params_splits.append(params_i)
    losses_splits.append(losses_i)
  params = tuple(torch.cat(leaves, dim=0) for leaves in zip(*params_splits))
  return params, np.concatenate(losses_splits, axis=0)
