"""Ensemble mean-field variational inference, on one device or over a mesh
(counterpart of `bayesnf_tpu/inference/vi.py`).

- Surrogate: an independent Normal(loc, 1e-4 + softplus(raw_scale)) per
  parameter entry, each leaf with a leading member axis E.
- Init: matrix locs from TruncatedNormal(0, 1, -2, 2), every other loc 0
  (the log-noise loc too: VI has no nanstd init), raw scales
  softplus_inverse(0.3). The locs are drawn as `map.init_ensemble` draws
  parameters: one CPU `torch.Generator` seeded with the int seed.
- Per-step loss of one member: the mean over S reparameterised draws z of
  log q(z) - prior(z) - loglik(z, batch) * (N/B) / kl_weight. The recorded
  history is that loss times kl_weight. The minibatch is redrawn every step
  from a per-member permutation prefix.
- The S draws of every member are folded into one member axis of E * S
  (member-major, draw-minor). The likelihood term comes from
  `map.make_nll_and_grads` on that axis: on 'kernel' one K1 call, whose
  per-member batches (E, ., B) feed each member's S draws as groups of
  rep = S (no S-fold copy); on 'torch' autograd through
  `field.apply_field_t` with the same grouped inputs. A full batch is the
  shared (D, N) layout. `_NLL` wraps either as an autograd Function: its
  forward keeps the gradients, its backward scales them by each member's
  cotangent, and autograd composes the sampling, log q and the prior
  around it.
- Randomness: the standard-normal noise of each step's draws (leaves in
  `param_specs` order), then its batch permutation, come from one generator
  on the fit's device seeded from the seed (`map.stream_seed`), so the two
  backends of one seed see the same noise and batches. The step function
  takes the noise and the batches as arguments.
- Adam (`map.adam_update`) over the locs and raw scales, one state.
- A mesh (`parallel/mesh.py`), as in `map.train`: the surrogates, padded to
  a multiple of the 'ens' extent, split into groups on the rows' first
  devices, and the rows into the balanced layout over the 'data' axis.
  Each step draws the noise of every member once (so every data shard of a
  group sees the same draws, as the JAX package's keys are split over
  'ens' only), each group samples its draws on its device, and `_NLL` sums
  the shards' NLLs and their gradients (K1 with the shard's `n_valid` on
  'kernel') in shard order; log q and the prior count once. Across ranks
  (`parallel/distributed.py`) every rank draws the noise of every member
  from the same generator and keeps its own groups' slice; a group whose
  shards live on several ranks gathers their terms first
  (`distributed.shard_exchange`); the surrogate and the posterior draws come back
  whole on every rank.

The observation model is NORMAL, NB or ZINB, and `precision` sets the
likelihood term's products as in `map.make_nll_and_grads` ('f32',
'highest' or 'bf16'); sampling, log q and the prior are fp32.

Checkpoints (`checkpoint_dir`) as in `map.ensemble_map`, in chunks of
`checkpoint_every` steps; a save holds the surrogate, the Adam state and
the step generator's state, so a resumed fit's surrogate, losses and
posterior draws equal the uninterrupted fit's, bit for bit. Host streaming
(`stream_chunk_steps`, `stream_train`): each step draws a fresh batch of B
rows on the host (`streaming.step_sample`), shared by every surrogate and
draw (K1's shared (D, B) input), or with `stream_member_remix` each
member's own remix of the slice (grouped inputs); the generator then draws
only the noise.

Spans (`utils/profiling.py`, while a profiler records): `train` is
`bnf.fit`; each step, over every ensemble group, `bnf.fit.step`, and in
it the noise and batch permutation `bnf.fit.draws`, then each group's
batch gather `bnf.fit.batch`, negative ELBO `bnf.fit.loss` (K1's call
inside it `bnf.k1`), autograd's backward `bnf.fit.backward` and Adam
`bnf.fit.adam` (the last three in `make_step`, so the streamed fit has
them too).
"""

import numpy as np
import torch

from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.models import priors
from bayesnf_torch.ops import special
from bayesnf_torch.parallel import distributed
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.parallel import minibatch as minibatch_lib
from bayesnf_torch.parallel import streaming as streaming_lib
from bayesnf_torch.utils import checkpoint as ckpt_lib
from bayesnf_torch.utils import profiling

# softplus_inverse(0.3), in double and rounded to float32 as the JAX package
# takes it.
RAW_SCALE_INIT = float(np.float32(
    special.softplus_inverse(torch.tensor(0.3, dtype=torch.float64))))


def init_surrogate(config, ensemble_size: int, seed: int, device):
  """(locs, raw_scales) of `ensemble_size` members on `device`."""
  locs = map_lib.init_ensemble(config, ensemble_size, seed, 0.0, device)
  return locs, tuple(torch.full_like(loc, RAW_SCALE_INIT) for loc in locs)


def surrogate_scales(raw_scales):
  return tuple(1e-4 + special.softplus(r) for r in raw_scales)


def draw_noise(config, members: int, samples: int, generator):
  """Standard-normal noise (members, samples, *leaf shape) per leaf, in
  `param_specs` order."""
  return tuple(
      torch.randn((members, samples) + spec.shape, generator=generator,
                  device=generator.device)
      for spec in field_lib.param_specs(config))


def surrogate_sample(locs, scales, noise):
  """Reparameterised draws loc + scale * noise, leaves (E, S, ...)."""
  return tuple(loc[:, None] + scale[:, None] * eps
               for loc, scale, eps in zip(locs, scales, noise))


def surrogate_log_prob(locs, scales, z):
  """(E, S) log q(z) of draws z with leaves (E, S, ...), summed leaf by
  leaf in `param_specs` order."""
  e, s = z[0].shape[:2]
  total = torch.zeros((e, s), dtype=torch.float32, device=z[0].device)
  for loc, scale, zi in zip(locs, scales, z):
    lp = special.normal_log_prob(zi, loc[:, None], scale[:, None])
    total = total + lp.reshape(e, s, -1).sum(dim=-1)
  return total


class _NLL(torch.autograd.Function):
  """lik_scale * -loglik per member from `nll_and_grads`, which gives the
  losses and their gradients in one pass (K1 on 'kernel'), summed over the
  row shards (`map.sum_over_shards`); the backward scales those gradients
  by each member's cotangent."""

  @staticmethod
  def forward(ctx, nll_and_grads, shards, exchange, *params):
    losses, grads = map_lib.sum_over_shards(nll_and_grads, params, shards,
                                            exchange)
    ctx.grads = grads
    return losses

  @staticmethod
  def backward(ctx, g):
    grads = ctx.grads
    del ctx.grads
    return (None, None, None,
            *(gr * g.reshape((-1,) + (1,) * (gr.ndim - 1)) for gr in grads))


def make_elbo_losses(config, distribution, lik_scale, backend,
                     precision='f32'):
  """`(locs, raw_scales, noise, *rows) -> (E,)` per-member negative ELBO,
  differentiable in the locs and raw scales.

  `lik_scale` is (N / B) / kl_weight; `noise` leaves are (E, S, ...);
  `rows` (`map.as_shards`) is x_b (D, N), seasonal_b (2F, N), y_b (N,), the
  full batch, or (E, D, B), (E, 2F, B), (E, B) per-member minibatches, or
  one sequence of row shards, every shard seeing the same draws
  (`exchange` as for `map.sum_over_shards`). The likelihood term's products
  run at `precision`.
  """
  nll_and_grads = map_lib.make_nll_and_grads(
      config, distribution, lik_scale, backend, precision)

  def elbo_losses(locs, raw_scales, noise, *rows, exchange=None):
    scales = surrogate_scales(raw_scales)
    z = surrogate_sample(locs, scales, noise)
    e, s = z[0].shape[:2]
    z_f = tuple(p.reshape((e * s,) + p.shape[2:]) for p in z)
    nll = _NLL.apply(nll_and_grads, map_lib.as_shards(rows), exchange, *z_f)
    target = (priors.prior_log_prob(config, z_f) - nll).reshape(e, s)
    return (surrogate_log_prob(locs, scales, z) - target).mean(dim=1)

  return elbo_losses


def make_step(config, distribution, lik_scale, learning_rate, backend,
              precision='f32'):
  """One Adam step of every surrogate: `(surrogate, opt_state, noise, *rows,
  exchange=None) -> (surrogate, opt_state, losses (E,))`, the losses before
  the update (see `make_elbo_losses` for the arguments)."""
  elbo_losses = make_elbo_losses(config, distribution, lik_scale, backend,
                                 precision)

  def step(surrogate, opt_state, noise, *rows, exchange=None):
    leaves = [p.detach().requires_grad_(True)
              for p in (*surrogate[0], *surrogate[1])]
    num = len(leaves) // 2
    with torch.enable_grad():
      with profiling.span('bnf.fit.loss'):
        losses = elbo_losses(leaves[:num], leaves[num:], noise, *rows,
                             exchange=exchange)
      with profiling.span('bnf.fit.backward'):
        grads = torch.autograd.grad(losses.sum(), leaves)
    with profiling.span('bnf.fit.adam'):
      updates, opt_state = map_lib.adam_update(grads, opt_state,
                                               learning_rate)
      new = tuple(p.detach() + u for p, u in zip(leaves, updates))
    return (new[:num], new[num:]), opt_state, losses.detach()

  return step


def train(surrogate, opt_state, aug_t, target, config, distribution,
          learning_rate, num_steps, batch_size, sample_size, kl_weight,
          generator, backend, precision='f32', mesh=None, noise=None):
  """`num_steps` VI steps, on one device or over `mesh` (see `map.train`);
  the likelihood term's products at `precision`.

  Each step `generator` draws the noise of every member (unless `noise`, a
  function `step -> ` leaves (E, S, ...), gives it), then its batches: a
  permutation prefix of B rows per member, or with several data shards and
  B % shards == 0, B / shards positions among each shard's valid rows
  (`minibatch.local_permutations`, shard by shard).

  Returns:
    (surrogate, opt_state, losses) on the mesh's first device: losses
    (E, num_steps), times kl_weight.

  Raises:
    ValueError: as `map.train`.
  """
  with profiling.span('bnf.fit'):
    mesh = map_lib.fit_mesh(mesh, target.device)
    shards = mesh.shape[mesh_lib.DATA_AXIS]
    n = target.shape[0]
    members = surrogate[0][0].shape[0]
    map_lib.check_batch_split(backend, batch_size, n, shards)
    step = make_step(config, distribution, (n / batch_size) / kl_weight,
                     learning_rate, backend, precision)
    rows = minibatch_lib.shard_rows(aug_t, target, mesh, config.num_inputs)
    local_rows, counts = minibatch_lib.shard_counts(n, shards)
    surrogates = split_surrogate(surrogate, mesh)
    states = map_lib.split_state(opt_state, mesh)
    size = members // len(surrogates)
    history = [None if s is None else [] for s in surrogates]
    for t in range(int(num_steps)):
      with profiling.span('bnf.fit.step'):
        with profiling.span('bnf.fit.draws'):
          eps = map_lib.split_groups(
              draw_noise(config, members, sample_size, generator)
              if noise is None else noise(t), mesh)
          if batch_size == n:
            perms = None
          elif shards > 1 and batch_size % shards == 0:
            perms = [minibatch_lib.local_permutations(
                generator, members, local_rows, n_s, batch_size // shards)
                     for n_s in counts]
          else:
            perms = map_lib.random_permutations(generator, members, n)
        batch = map_lib.batch_rows(rows, n, batch_size, perms, size)
        for i, state in enumerate(states):
          if state is None:
            continue
          with profiling.span('bnf.fit.batch'):
            rows_i = batch(i, 0)
          surrogates[i], states[i], losses = step(
              surrogates[i], state, eps[i], rows_i,
              exchange=distributed.shard_exchange(mesh, i))
          history[i].append(losses)
    surrogate, opt_state = gather_surrogate(surrogates, states, mesh)
    return (surrogate, opt_state,
            map_lib.gather_losses(history, mesh, members) * kl_weight)


def split_surrogate(surrogate, mesh):
  """(locs, raw_scales) of each ensemble group (`map.split_groups`; None
  for a group of another rank)."""
  return [None if locs is None else (locs, raw) for locs, raw in zip(
      map_lib.split_groups(surrogate[0], mesh),
      map_lib.split_groups(surrogate[1], mesh))]


def gather_surrogate(surrogates, states, mesh):
  """The groups' surrogates and Adam states joined on the mesh's first
  device, on every rank (`map.gather_state`)."""
  leaves, opt_state = map_lib.gather_state(
      [None if s is None else (*s[0], *s[1]) for s in surrogates], states,
      mesh)
  num = len(leaves) // 2
  return (leaves[:num], leaves[num:]), opt_state


def posterior_draws(config, surrogate, num_samples: int, generator):
  """Parameter draws from each surrogate, leaves (E, num_samples, ...)."""
  locs, raw_scales = surrogate
  noise = draw_noise(config, locs[0].shape[0], num_samples, generator)
  return surrogate_sample(locs, surrogate_scales(raw_scales), noise)


def stream_train(surrogate, opt_state, stream, config, distribution,
                 learning_rate, num_steps, sample_size, kl_weight, generator,
                 backend, precision='f32', mesh=None, slice_steps=1,
                 start_step=0, checkpoint_every=None, on_chunk=None,
                 remix_seed=None):
  """Steps `start_step` to `num_steps` of a streamed VI fit, on one device
  or over `mesh` (see `train` and `map.stream_train`).

  Each step `generator` draws the noise of every member; its batch comes
  from `stream` (`per_step_resample`), sent to the mesh's first device
  `slice_steps` steps at a time.

  Args:
    checkpoint_every: steps a chunk, or None (one chunk).
    on_chunk: None, or `(surrogate, opt_state, losses, steps_done)` after
      each chunk, with the chunk's losses (E, chunk steps) times kl_weight,
      all on the mesh's first device.
    remix_seed: None (the shared stream), or the fit's seed: each member
      remixes each slice (`map.slice_remix`).
    (the rest as for `train`).

  Returns:
    (surrogate, opt_state, losses) on the mesh's first device: losses
    (E, num_steps - start_step), times kl_weight.
  """
  mesh = map_lib.fit_mesh(mesh, surrogate[0][0].device)
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  members = surrogate[0][0].shape[0]
  map_lib.check_batch_split(backend, stream.batch_size, stream.data_size,
                            shards)
  step = make_step(config, distribution,
                   (stream.data_size / stream.batch_size) / kl_weight,
                   learning_rate, backend, precision)
  first = mesh.first_device
  surrogates = split_surrogate(surrogate, mesh)
  states = map_lib.split_state(opt_state, mesh)
  size = members // len(surrogates)
  history = []

  def run_slice(state, aug_s, y_s, slice_step):
    surrogates, states = state
    steps = aug_s.shape[0]
    batch = map_lib.stream_batches(
        aug_s, y_s, config.num_inputs, mesh, size,
        map_lib.slice_remix(remix_seed, slice_step, steps, members,
                            stream.batch_size // shards, first))
    losses = []
    for k in range(steps):
      eps = map_lib.split_groups(
          draw_noise(config, members, sample_size, generator), mesh)
      step_losses = [None] * len(states)
      for i, group_state in enumerate(states):
        if group_state is None:
          continue
        surrogates[i], states[i], step_losses[i] = step(
            surrogates[i], group_state, eps[i], batch(i, k),
            exchange=distributed.shard_exchange(mesh, i))
      losses.append(step_losses)
    return state, losses

  def chunk_done(state, step_losses, steps_done):
    history.append(torch.stack(map_lib.gather_step_losses(
        step_losses, mesh, members), dim=1) * kl_weight)
    if on_chunk is not None:
      on_chunk(*gather_surrogate(*state, mesh), history[-1], steps_done)

  surrogates, states = streaming_lib.run_stream_driver(
      stream, device=first, run_slice=run_slice, state=(surrogates, states),
      start_step=int(start_step), num_steps=int(num_steps),
      slice_steps=int(slice_steps), checkpoint_steps=checkpoint_every,
      on_chunk=chunk_done,
      columns=map_lib.stream_columns(mesh, stream.batch_size))
  losses = (torch.cat(history, dim=1) if history
            else torch.zeros((members, 0), device=first))
  return (*gather_surrogate(surrogates, states, mesh), losses)


def fit_vi(
    aug_features,
    target,
    seed: int,
    observation_model: str,
    config: field_lib.FieldConfig,
    ensemble_size: int,
    learning_rate: float,
    num_epochs: int,
    sample_size_divergence: int = 5,
    sample_size_posterior: int = 30,
    kl_weight: float = 1.0,
    batch_size: int | None = None,
    backend: str = 'auto',
    device='cuda',
    precision: str = 'f32',
    mesh=None,
    checkpoint_dir=None,
    checkpoint_every: int | None = None,
    stream_chunk_steps: int | None = None,
    stream_member_remix: bool = False,
):
  """Fit an ensemble of mean-field surrogate posteriors.

  Args:
    aug_features: (N, D + 2F) inputs with seasonal features
      (`field.aug_features`), numpy or a tensor; for a streamed fit numpy
      or an `np.memmap` (`field.aug_features_host`), which stays on the
      host.
    target: (N,) targets (numpy).
    seed: int seed of the init, of the per-step noise and batches, and of
      a streamed fit's batches (`map.stream_seed(seed, map.HOST_STREAM)`)
      and remix.
    observation_model: 'NORMAL' | 'NB' | 'ZINB'.
    config: model config.
    ensemble_size: surrogates to fit.
    learning_rate: Adam learning rate.
    num_epochs: total optimization steps (the estimator scales its epochs
      by N // B, as the JAX package does).
    sample_size_divergence: Monte-Carlo draws per ELBO estimate (S).
    sample_size_posterior: posterior draws returned per surrogate.
    kl_weight: weight of KL(q || prior) in the ELBO.
    batch_size: rows per step; None (or at least N) is the full batch.
    backend: 'auto' | 'torch' | 'kernel' (`backends.resolve_backend`).
    device: where the fit runs without a mesh.
    precision: 'f32' | 'highest' (the same, bit for bit) | 'bf16', for the
      likelihood term's products (`map.make_nll_and_grads`).
    mesh: None, or a `parallel.mesh.Mesh` to fit over (`train`); the
      surrogates are padded to a multiple of its 'ens' extent and the
      padding is dropped on the way out.
    checkpoint_dir: as for `map.ensemble_map`, in chunks of
      `checkpoint_every` steps (default num_epochs // 10, at least 1).
    checkpoint_every: steps a checkpoint chunk.
    stream_chunk_steps: None, or streamed training in slices of this many
      steps (`stream_train`; minibatch fits only).
    stream_member_remix: as for `map.ensemble_map`.

  Returns:
    (surrogate, losses, draws): (locs, raw_scales) with leading member axis
    E on `device` (with a mesh, its first device); losses (E, num_epochs)
    as numpy (times kl_weight); draws, leaves (E, sample_size_posterior,
    ...) beside the surrogate.

  Raises:
    ValueError: as `map.ensemble_map`.
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  mesh = map_lib.fit_mesh(mesh, device)
  target_np = np.asarray(target)
  n = int(target_np.shape[0])
  batch_size = n if batch_size is None else min(int(batch_size), n)
  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  streaming = map_lib.check_supported(
      batch_size, n, data_shards, stream_chunk_steps, stream_member_remix)
  backend = map_lib.resolve_fit_backend(backend, mesh, config, distribution,
                                        batch_size, n)
  num_steps = int(num_epochs)
  sample_size = int(sample_size_divergence)
  first = mesh.first_device
  padded = mesh_lib.pad_ensemble_size(ensemble_size, mesh)
  surrogate = init_surrogate(config, padded, seed, first)
  opt_state = map_lib.init_opt_state((*surrogate[0], *surrogate[1]))
  generator = torch.Generator(device=first).manual_seed(
      map_lib.stream_seed(seed, map_lib.VI_STEP_STREAM))
  checkpointer, restored, checkpoint_every = map_lib.open_checkpointer(
      checkpoint_dir, checkpoint_every, num_steps, streaming,
      stream_member_remix, stream_chunk_steps, mesh, kind='vi',
      config=config,
      distribution=distribution.value, ensemble_size=ensemble_size,
      learning_rate=float(learning_rate),
      batch_size=int(batch_size), data_size=n,
      sample_size_divergence=sample_size, kl_weight=float(kl_weight),
      precision=precision, backend=backend, data_shards=data_shards)
  step, loss_chunks = 0, []
  if restored is not None:
    leaves, (count, mu, nu) = restored.place(first)
    num = len(leaves) // 2
    surrogate = (leaves[:num], leaves[num:])
    opt_state = map_lib.AdamState(count, mu, nu)
    restored.restore_generators([generator])
    loss_chunks = [t.to(first) for t in restored.losses]
    step = restored.epoch

  def save(surrogate, opt_state, steps_done):
    if checkpointer is not None:
      checkpointer.save(ckpt_lib.TrainState.from_fit(
          (*surrogate[0], *surrogate[1]), opt_state, [generator],
          loss_chunks, steps_done))

  if streaming:
    aug_t, y = map_lib.host_rows(aug_features, target_np)
    stream = streaming_lib.HostBatchStream(
        aug_t, y, batch_size,
        (map_lib.stream_seed(seed, map_lib.HOST_STREAM),),
        per_step_resample=True)
    if stream_member_remix:
      streaming_lib.validate_remix_alignment(
          int(stream_chunk_steps), step, checkpoint_every)

    def on_chunk(surrogate, opt_state, losses, steps_done):
      loss_chunks.append(losses)
      save(surrogate, opt_state, steps_done)

    surrogate, opt_state, _ = stream_train(
        surrogate, opt_state, stream, config, distribution, learning_rate,
        num_steps, sample_size, float(kl_weight), generator, backend,
        precision, mesh=mesh, slice_steps=int(stream_chunk_steps),
        start_step=step, checkpoint_every=checkpoint_every,
        on_chunk=on_chunk,
        remix_seed=seed if stream_member_remix else None)
  else:
    aug_t = torch.as_tensor(
        aug_features, dtype=torch.float32, device=first).T.contiguous()
    y = torch.tensor(target_np, dtype=torch.float32, device=first)
    while step < num_steps:
      chunk = (num_steps - step if checkpoint_every is None
               else min(checkpoint_every, num_steps - step))
      surrogate, opt_state, losses = train(
          surrogate, opt_state, aug_t, y, config, distribution,
          learning_rate, chunk, batch_size, sample_size, float(kl_weight),
          generator, backend, precision, mesh=mesh)
      loss_chunks.append(losses)
      step += chunk
      # The last chunk is saved too: a finished fit run again is a no-op.
      save(surrogate, opt_state, step)
  losses = (torch.cat(loss_chunks, dim=1) if loss_chunks
            else torch.zeros((padded, 0), device=first))
  draws = posterior_draws(config, surrogate, int(sample_size_posterior),
                          generator)

  def real(leaves):
    return tuple(t[:ensemble_size] for t in leaves)

  return ((real(surrogate[0]), real(surrogate[1])),
          losses[:ensemble_size].cpu().numpy(), real(draws))
