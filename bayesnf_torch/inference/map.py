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
  by autograd, after the likelihood. The observation model is NORMAL, NB
  or ZINB on both.
- `fit_map` keeps the `num_splits` host loop over ensemble chunks.
- A mesh (`parallel/mesh.py`, single process; a device may repeat): the
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
- `precision` ('f32', 'highest' or 'bf16', `ops/mixed.py`) sets the
  products of both backends: on 'torch' every dense layer's product
  (`mixed.matmul_bf16` under 'bf16', as the JAX package's XLA path), on
  'kernel' K1's (as its TPU kernel). 'highest' is 'f32' bit for bit. The
  'torch' backend's fp32 products run in true fp32 whatever the caller set
  (`mixed.fp32_matmuls`).

Not ported yet, and raising NotImplementedError: checkpoints and host
streaming (ROADMAP.md, queue 1).
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
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.parallel import minibatch as minibatch_lib

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
  """-prior_weight * prior_log_prob per member, and its gradient."""
  leaves = [p.detach().requires_grad_(True) for p in params]
  with torch.enable_grad():
    losses = -prior_weight * priors.prior_log_prob(config, leaves)
    grads = torch.autograd.grad(losses.sum(), leaves)
  return losses.detach(), list(grads)


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


def sum_over_shards(nll_and_grads, params, shards):
  """`nll_and_grads` of `params` summed over row shards.

  Each shard is the arguments after `params` of one call (x_t, seasonal_t,
  y[, n_valid[, row_weights]]), all on one device: the parameters go there, and
  the shard's losses and gradients come back to the parameters' device and
  are added in shard order, so the sum does not depend on which device
  finishes first. One shard on the parameters' device is one plain call.
  """
  home = params[0].device
  total = None
  for shard in shards:
    local = tuple(p.to(shard[2].device) for p in params)
    losses, grads = nll_and_grads(local, *shard)
    losses, grads = losses.to(home), [g.to(home) for g in grads]
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
  (E, D, B), or a sequence of row shards."""
  nll_and_grads = make_nll_and_grads(config, distribution, lik_scale, backend,
                                     precision)

  def losses_and_grads(params, *rows):
    losses, grads = sum_over_shards(nll_and_grads, params, as_shards(rows))
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
  `batch_size` rows, gathered on the shards' devices."""
  shards = len(rows[0])
  if batch_size == data_size:
    return lambda i, k: rows[i]

  def members(t, i):
    return t[i * group_size:(i + 1) * group_size]

  if shards > 1 and batch_size % shards == 0:
    local = batch_size // shards

    def local_batch(i, k):
      return [gather_batch(r.x_t, r.seasonal_t, r.y, members(
          p, i)[:, k * local:(k + 1) * local].to(r.y.device))
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
  local_rows = rows[0][0].y.shape[0]
  stored = torch.as_tensor(minibatch_lib.stored_positions(
      data_size, shards), device=keep.device)[keep]

  def spread_batch(i, k):
    pos = members(stored, i)[:, k * batch_size:(k + 1) * batch_size]
    out = []
    for j, r in enumerate(rows[i]):
      at = (pos - j * local_rows).to(r.y.device)
      held = (at >= 0) & (at < local_rows)
      out.append((*gather_batch(r.x_t, r.seasonal_t, r.y,
                                at.clamp(0, local_rows - 1)),
                  None, held.float()))
    return out

  return spread_batch


def split_groups(leaves, mesh):
  """Leaves with a leading member axis E split into the mesh's ensemble
  groups: group i, members [i E / ens, (i + 1) E / ens), on the first
  device of the mesh's row i.

  Raises:
    ValueError: if E is not a multiple of the 'ens' extent.
  """
  groups = mesh.shape[mesh_lib.ENSEMBLE_AXIS]
  members = leaves[0].shape[0]
  if members % groups:
    raise ValueError(
        f'{members} members do not split into {groups} ensemble groups; pad '
        'them to a multiple (`mesh.pad_ensemble_size`).')
  size = members // groups
  return [tuple(t[i * size:(i + 1) * size].to(row[0]) for t in leaves)
          for i, row in enumerate(mesh.devices)]


def gather_groups(groups, device):
  """`split_groups` undone: each leaf's groups joined on `device` (one
  group: its leaves as they are)."""
  return tuple(parts[0] if len(parts) == 1 else
               torch.cat([t.to(device) for t in parts])
               for parts in zip(*groups))


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
    (params, opt_state, losses) on the mesh's first device: losses
    (E, num_epochs), each epoch's loss before its update (full batch) or the
    mean of its steps' losses (minibatch).

  Raises:
    ValueError: if E does not split into the mesh's ensemble groups, or
      for 'kernel' with a minibatch that does not split evenly over the
      data shards.
  """
  mesh = fit_mesh(mesh, target.device)
  n = target.shape[0]
  batch_size = n if batch_size is None else min(int(batch_size), n)
  check_batch_split(backend, batch_size, n, mesh.shape[mesh_lib.DATA_AXIS])
  losses_and_grads = make_losses_and_grads(
      config, distribution, prior_weight, backend, lik_scale=n / batch_size,
      precision=precision)
  rows = minibatch_lib.shard_rows(aug_t, target, mesh, config.num_inputs)
  params = split_groups(params, mesh)
  states = [AdamState(opt_state.count, mu, nu) for mu, nu in zip(
      split_groups(opt_state.mu, mesh), split_groups(opt_state.nu, mesh))]
  size = params[0][0].shape[0]
  num_batches = n // batch_size
  history = [[] for _ in params]
  for epoch in range(int(num_epochs)):
    batch = batch_rows(rows, n, batch_size,
                       None if batch_size == n else permutations(epoch), size)
    step_losses = [[] for _ in params]
    for k in range(num_batches):
      for i, state in enumerate(states):
        losses, grads = losses_and_grads(params[i], batch(i, k))
        updates, states[i] = adam_update(grads, state, learning_rate)
        params[i] = tuple(p + u for p, u in zip(params[i], updates))
        step_losses[i].append(losses)
    for i, group in enumerate(step_losses):
      history[i].append(group[0] if num_batches == 1 else
                        torch.stack(group).mean(dim=0))
  first = mesh.first_device
  losses = gather_groups(
      [(torch.stack(h, dim=1) if h else
        torch.zeros((size, 0), device=p[0].device),) for h, p in zip(
            history, params)], first)[0]
  return (gather_groups(params, first),
          AdamState(states[0].count,
                    gather_groups([s.mu for s in states], first),
                    gather_groups([s.nu for s in states], first)),
          losses)


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


def check_supported(checkpoint_dir=None, checkpoint_every=None,
                    stream_chunk_steps=None, stream_member_remix=False):
  """Raises NotImplementedError for what the port does not train yet."""
  if checkpoint_dir is not None or checkpoint_every is not None:
    raise NotImplementedError(
        'Checkpointing is not ported to PyTorch yet (ROADMAP.md, queue 1 '
        'item 14).'
    )
  if stream_chunk_steps is not None or stream_member_remix:
    raise NotImplementedError(
        'Host streaming is not ported to PyTorch yet (ROADMAP.md, queue 1 '
        'item 12).'
    )


def fit_mesh(mesh, device):
  """The mesh of a fit: `mesh` itself, or one `device` (a 1 x 1 mesh).

  Raises:
    TypeError: if `mesh` is not a `parallel.mesh.Mesh`.
  """
  if mesh is None:
    return mesh_lib.Mesh([[device]])
  return mesh_lib.check_mesh(mesh)


def resolve_fit_backend(backend, mesh, config, distribution, batch_size,
                        data_size):
  """`backends.resolve_backend` for a fit of `distribution` over `mesh`."""
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  return backends.resolve_backend(
      backend, mesh.device_type, config,
      likelihoods.LikelihoodDist(distribution).value, data_shards=shards,
      full_batch=batch_size == data_size,
      batch_divisible=batch_size % shards == 0)


def seeded_permutations(seed, members, data_size, batch_size, mesh):
  """The `permutations` of a minibatch MAP fit (see `train`), drawn on the
  mesh's first device, each member from a generator of its own: every
  epoch member m's permutation of the rows from `stream_seed(seed,
  PERMUTATION_STREAM, m)`, or, with a batch that splits evenly over several
  data shards, its local permutation of shard j from `stream_seed(seed,
  PERMUTATION_STREAM, m, j)` (an RNG deviation from the JAX package, which
  folds the shard into each member's key). A member's batches do not depend
  on how many members an ensemble is padded to."""
  device = mesh.first_device
  shards = mesh.shape[mesh_lib.DATA_AXIS]

  def uniforms(n, *key):
    generators = [torch.Generator(device=device).manual_seed(
        stream_seed(seed, PERMUTATION_STREAM, m, *key))
                  for m in range(members)]
    return lambda: torch.stack([torch.rand(n, generator=g, device=device)
                                for g in generators])

  if shards > 1 and batch_size % shards == 0:
    local_rows, counts = minibatch_lib.shard_counts(data_size, shards)
    count = data_size // batch_size * (batch_size // shards)
    draws = [uniforms(local_rows, j) for j in range(shards)]
    return lambda _: [minibatch_lib.local_permutation(draw(), n_s, count)
                      for draw, n_s in zip(draws, counts)]
  draw = uniforms(data_size)
  return lambda _: torch.argsort(draw(), dim=1)


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
    **unported,
):
  """Train `ensemble_size` independent MAP/MLE members.

  Args:
    aug_features: (N, D + 2F) training inputs with seasonal features
      appended (`field.aug_features`), numpy or a tensor.
    target: (N,) training targets (numpy).
    config: model config.
    distribution: observation model.
    ensemble_size: members to train.
    learning_rate: Adam learning rate.
    num_epochs: epochs (N // batch_size steps each).
    seed: int seed of the initialization, and of the minibatch
      permutations (`seeded_permutations`).
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
    **unported: the JAX package's checkpoint and streaming arguments;
      anything but their defaults raises.

  Returns:
    (params, losses): params with leading member axis (ensemble_size, ...)
    on `device` (with a mesh, its first device); losses (ensemble_size,
    num_epochs) as numpy.
  """
  target_np = np.asarray(target)
  check_supported(**unported)
  mesh = fit_mesh(mesh, device)
  n = target_np.shape[0]
  batch_size = n if batch_size is None else min(int(batch_size), n)
  backend = resolve_fit_backend(backend, mesh, config, distribution,
                                batch_size, n)
  padded = mesh_lib.pad_ensemble_size(ensemble_size, mesh)
  first = mesh.first_device
  log_noise_init = np.log(np.nanstd(target_np) / 2.0)
  params = init_ensemble(
      config, padded, seed, float(np.float32(log_noise_init)), first)
  aug_t = torch.as_tensor(
      aug_features, dtype=torch.float32, device=first).T.contiguous()
  y = torch.tensor(target_np, dtype=torch.float32, device=first)
  params, _, losses = train(
      params, init_opt_state(params), aug_t, y, config,
      likelihoods.LikelihoodDist(distribution), learning_rate, num_epochs,
      prior_weight=prior_weight, backend=backend, batch_size=batch_size,
      permutations=(None if batch_size == n else
                    seeded_permutations(seed, padded, n, batch_size, mesh)),
      precision=precision, mesh=mesh,
  )
  return (tuple(p[:ensemble_size] for p in params),
          losses[:ensemble_size].cpu().numpy())


# Keys of the random streams a fit derives from its int seed (the
# initialization uses the seed itself).
PERMUTATION_STREAM = 1
VI_STEP_STREAM = 2
# The CLI's CRPS draws (`cli/evaluate.py`).
CRPS_STREAM = 3


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
    **unported,
):
  """Fit a MAP/MLE ensemble in `num_splits` sequential splits, each over
  `mesh` if one is given (`ensemble_map`).

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
        device=device, precision=precision, mesh=mesh, **unported,
    )
    params_splits.append(params_i)
    losses_splits.append(losses_i)
  params = tuple(torch.cat(leaves, dim=0) for leaves in zip(*params_splits))
  return params, np.concatenate(losses_splits, axis=0)
