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
  'kernel') in shard order; log q and the prior count once.

The observation model is NORMAL, NB or ZINB, and `precision` sets the
likelihood term's products as in `map.make_nll_and_grads` ('f32',
'highest' or 'bf16'); sampling, log q and the prior are fp32. Not ported
yet, and raising NotImplementedError: checkpoints and host streaming
(ROADMAP.md, queue 1).
"""

import numpy as np
import torch

from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.models import priors
from bayesnf_torch.ops import special
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.parallel import minibatch as minibatch_lib

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
  def forward(ctx, nll_and_grads, shards, *params):
    losses, grads = map_lib.sum_over_shards(nll_and_grads, params, shards)
    ctx.grads = grads
    return losses

  @staticmethod
  def backward(ctx, g):
    grads = ctx.grads
    del ctx.grads
    return (None, None,
            *(gr * g.reshape((-1,) + (1,) * (gr.ndim - 1)) for gr in grads))


def make_elbo_losses(config, distribution, lik_scale, backend,
                     precision='f32'):
  """`(locs, raw_scales, noise, *rows) -> (E,)` per-member negative ELBO,
  differentiable in the locs and raw scales.

  `lik_scale` is (N / B) / kl_weight; `noise` leaves are (E, S, ...);
  `rows` (`map.as_shards`) is x_b (D, N), seasonal_b (2F, N), y_b (N,), the
  full batch, or (E, D, B), (E, 2F, B), (E, B) per-member minibatches, or
  one sequence of row shards, every shard seeing the same draws. The
  likelihood term's products run at `precision`.
  """
  nll_and_grads = map_lib.make_nll_and_grads(
      config, distribution, lik_scale, backend, precision)

  def elbo_losses(locs, raw_scales, noise, *rows):
    scales = surrogate_scales(raw_scales)
    z = surrogate_sample(locs, scales, noise)
    e, s = z[0].shape[:2]
    z_f = tuple(p.reshape((e * s,) + p.shape[2:]) for p in z)
    nll = _NLL.apply(nll_and_grads, map_lib.as_shards(rows), *z_f)
    target = (priors.prior_log_prob(config, z_f) - nll).reshape(e, s)
    return (surrogate_log_prob(locs, scales, z) - target).mean(dim=1)

  return elbo_losses


def make_step(config, distribution, lik_scale, learning_rate, backend,
              precision='f32'):
  """One Adam step of every surrogate: `(surrogate, opt_state, noise, *rows)
  -> (surrogate, opt_state, losses (E,))`, the losses before the update
  (see `make_elbo_losses` for the arguments)."""
  elbo_losses = make_elbo_losses(config, distribution, lik_scale, backend,
                                 precision)

  def step(surrogate, opt_state, noise, *rows):
    leaves = [p.detach().requires_grad_(True)
              for p in (*surrogate[0], *surrogate[1])]
    num = len(leaves) // 2
    with torch.enable_grad():
      losses = elbo_losses(leaves[:num], leaves[num:], noise, *rows)
      grads = torch.autograd.grad(losses.sum(), leaves)
    updates, opt_state = map_lib.adam_update(grads, opt_state, learning_rate)
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
  mesh = map_lib.fit_mesh(mesh, target.device)
  shards = mesh.shape[mesh_lib.DATA_AXIS]
  n = target.shape[0]
  members = surrogate[0][0].shape[0]
  map_lib.check_batch_split(backend, batch_size, n, shards)
  step = make_step(config, distribution, (n / batch_size) / kl_weight,
                   learning_rate, backend, precision)
  rows = minibatch_lib.shard_rows(aug_t, target, mesh, config.num_inputs)
  local_rows, counts = minibatch_lib.shard_counts(n, shards)
  surrogates = list(zip(map_lib.split_groups(surrogate[0], mesh),
                        map_lib.split_groups(surrogate[1], mesh)))
  states = [map_lib.AdamState(opt_state.count, mu, nu) for mu, nu in zip(
      map_lib.split_groups(opt_state.mu, mesh),
      map_lib.split_groups(opt_state.nu, mesh))]
  size = members // len(surrogates)
  history = [[] for _ in surrogates]
  for t in range(int(num_steps)):
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
      surrogates[i], states[i], losses = step(surrogates[i], state, eps[i],
                                              batch(i, 0))
      history[i].append(losses)
  first = mesh.first_device
  losses = map_lib.gather_groups(
      [(torch.stack(h, dim=1) if h else
        torch.zeros((size, 0), device=s[0][0].device),)
       for h, s in zip(history, surrogates)], first)[0]
  surrogate = tuple(map_lib.gather_groups(part, first)
                    for part in zip(*surrogates))
  opt_state = map_lib.AdamState(
      states[0].count,
      map_lib.gather_groups([s.mu for s in states], first),
      map_lib.gather_groups([s.nu for s in states], first))
  return surrogate, opt_state, losses * kl_weight


def posterior_draws(config, surrogate, num_samples: int, generator):
  """Parameter draws from each surrogate, leaves (E, num_samples, ...)."""
  locs, raw_scales = surrogate
  noise = draw_noise(config, locs[0].shape[0], num_samples, generator)
  return surrogate_sample(locs, surrogate_scales(raw_scales), noise)


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
    **unported,
):
  """Fit an ensemble of mean-field surrogate posteriors.

  Args:
    aug_features: (N, D + 2F) inputs with seasonal features
      (`field.aug_features`), numpy or a tensor.
    target: (N,) targets (numpy).
    seed: int seed of the init and of the per-step noise and batches.
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
    **unported: the JAX package's checkpoint and streaming arguments;
      anything but their defaults raises.

  Returns:
    (surrogate, losses, draws): (locs, raw_scales) with leading member axis
    E on `device` (with a mesh, its first device); losses (E, num_epochs)
    as numpy (times kl_weight); draws, leaves (E, sample_size_posterior,
    ...) beside the surrogate.
  """
  distribution = likelihoods.LikelihoodDist(observation_model)
  map_lib.check_supported(**unported)
  mesh = map_lib.fit_mesh(mesh, device)
  target_np = np.asarray(target)
  n = int(target_np.shape[0])
  batch_size = n if batch_size is None else min(int(batch_size), n)
  backend = map_lib.resolve_fit_backend(backend, mesh, config, distribution,
                                        batch_size, n)
  first = mesh.first_device
  padded = mesh_lib.pad_ensemble_size(ensemble_size, mesh)
  surrogate = init_surrogate(config, padded, seed, first)
  opt_state = map_lib.init_opt_state((*surrogate[0], *surrogate[1]))
  aug_t = torch.as_tensor(
      aug_features, dtype=torch.float32, device=first).T.contiguous()
  y = torch.tensor(target_np, dtype=torch.float32, device=first)
  generator = torch.Generator(device=first).manual_seed(
      map_lib.stream_seed(seed, map_lib.VI_STEP_STREAM))
  surrogate, _, losses = train(
      surrogate, opt_state, aug_t, y, config, distribution, learning_rate,
      num_epochs, batch_size, int(sample_size_divergence), float(kl_weight),
      generator, backend, precision, mesh=mesh)
  draws = posterior_draws(config, surrogate, int(sample_size_posterior),
                          generator)

  def real(leaves):
    return tuple(t[:ensemble_size] for t in leaves)

  return ((real(surrogate[0]), real(surrogate[1])),
          losses[:ensemble_size].cpu().numpy(), real(draws))
