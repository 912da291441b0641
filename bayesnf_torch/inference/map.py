"""Ensemble MAP / MLE trainer, one device (counterpart of
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
- `precision` ('f32', 'highest' or 'bf16', `ops/mixed.py`) sets the
  products of both backends: on 'torch' every dense layer's product
  (`mixed.matmul_bf16` under 'bf16', as the JAX package's XLA path), on
  'kernel' K1's (as its TPU kernel). 'highest' is 'f32' bit for bit. The
  'torch' backend's fp32 products run in true fp32 whatever the caller set
  (`mixed.fp32_matmuls`).

Not ported yet, and raising NotImplementedError: checkpoints, host
streaming and a device mesh (ROADMAP.md, queue 1).
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
  """The `(params, x_t, seasonal_t, y) -> (losses (E,), grads)` of
  `lik_scale * -loglik` on `backend` ('torch' or 'kernel', resolved), its
  products at `precision`.

  x_t (D, B), seasonal_t (2F, B) and y (B,) are shared by every member, or
  grouped with a leading axis that divides E (`field.grouped`).
  """
  mixed.check_precision(precision)

  def torch_nll_and_grads(params, x_t, seasonal_t, y):
    losses = torch.zeros_like(params[0]).reshape(-1)
    grads = [torch.zeros_like(p) for p in params]
    leaves = [p.detach().requires_grad_(True) for p in params]
    for lo in range(0, y.shape[-1], ROW_CHUNK):
      rows = slice(lo, lo + ROW_CHUNK)
      with torch.enable_grad(), mixed.fp32_matmuls():
        pred = field_lib.apply_field_t(
            config, leaves, x_t[..., rows], seasonal_t[..., rows], precision)
        chunk_losses = -lik_scale * likelihoods.log_likelihood(
            distribution, leaves, pred, y[..., rows]
        )
        # NORMAL leaves the NB/ZINB scalars out of the graph: zero grads.
        chunk_grads = torch.autograd.grad(
            chunk_losses.sum(), leaves, allow_unused=True,
            materialize_grads=True)
      losses = losses + chunk_losses.detach()
      grads = [g + cg for g, cg in zip(grads, chunk_grads)]
    return losses, grads

  def kernel_nll_and_grads(params, x_t, seasonal_t, y):
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
        precision=precision,
    )
    return losses, field_lib.scatter_fused_train_grads(
        config, dlsa, dfs, dws, dbs, dscales, dlogit, dobs)

  if backend == 'kernel':
    return kernel_nll_and_grads
  if backend == 'torch':
    return torch_nll_and_grads
  raise ValueError(f'Unresolved backend: {backend!r}')


def make_losses_and_grads(config, distribution, prior_weight, backend,
                          lik_scale=1.0, precision='f32'):
  """The per-step `(params, x_t, seasonal_t, y) -> (losses (E,), grads)` of
  a fit on `backend` ('torch' or 'kernel', resolved): `lik_scale` (N / B)
  times the negative log-likelihood of the step's rows, shared (D, B) or
  per member (E, D, B) (`make_nll_and_grads`, at `precision`), plus the
  prior."""
  nll_and_grads = make_nll_and_grads(config, distribution, lik_scale, backend,
                                     precision)

  def losses_and_grads(params, x_t, seasonal_t, y):
    losses, grads = nll_and_grads(params, x_t, seasonal_t, y)
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
):
  """`num_epochs` Adam epochs from `params` and `opt_state`.

  Args:
    params: flat parameter tuple, each leaf with a leading member axis E.
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
    permutations: with B < N, a function `epoch -> (E, N)` row permutation
      per member (`random_permutations` from a seeded generator in a fit;
      tests give the JAX package's).
    precision: 'f32' | 'highest' | 'bf16' (`make_nll_and_grads`).

  Returns:
    (params, opt_state, losses): losses (E, num_epochs) on the parameters'
    device: each epoch's loss before its update (full batch) or the mean of
    its steps' losses (minibatch).
  """
  d = config.num_inputs
  n = target.shape[0]
  batch_size = n if batch_size is None else min(int(batch_size), n)
  losses_and_grads = make_losses_and_grads(
      config, distribution, prior_weight, backend, lik_scale=n / batch_size,
      precision=precision)
  x_t, seasonal_t = aug_t[:d], aug_t[d:]
  params = tuple(params)
  num_batches = n // batch_size
  history = []
  for epoch in range(int(num_epochs)):
    if batch_size == n:
      batches = [(x_t, seasonal_t, target)]
    else:
      keep = permutations(epoch)[:, : num_batches * batch_size]
      batches = (gather_batch(x_t, seasonal_t, target,
                              keep[:, j * batch_size : (j + 1) * batch_size])
                 for j in range(num_batches))
    step_losses = []
    for batch in batches:
      losses, grads = losses_and_grads(params, *batch)
      updates, opt_state = adam_update(grads, opt_state, learning_rate)
      params = tuple(p + u for p, u in zip(params, updates))
      step_losses.append(losses)
    history.append(step_losses[0] if len(step_losses) == 1 else
                   torch.stack(step_losses).mean(dim=0))
  losses = (torch.stack(history, dim=1) if history else
            torch.zeros((params[0].shape[0], 0), device=params[0].device))
  return params, opt_state, losses


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


def check_supported(mesh=None, checkpoint_dir=None, checkpoint_every=None,
                    stream_chunk_steps=None, stream_member_remix=False):
  """Raises NotImplementedError for what the port does not train yet."""
  if mesh is not None:
    raise NotImplementedError(
        'A device mesh is not ported to PyTorch yet (ROADMAP.md, queue 1 '
        'item 15); the port trains on one device.'
    )
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
      permutations (`stream_seed(seed, PERMUTATION_STREAM)`).
    batch_size: None or N (full batch), or B < N rows per step.
    prior_weight: prior multiplier (0 == MLE).
    backend: 'auto' | 'torch' | 'kernel' (`backends.resolve_backend`).
    device: where the fit runs.
    precision: 'f32' | 'highest' (the same, bit for bit) | 'bf16'
      (`make_nll_and_grads`).
    **unported: the JAX package's mesh, checkpoint and streaming
      arguments; anything but their defaults raises.

  Returns:
    (params, losses): params with leading member axis (ensemble_size, ...)
    on `device`; losses (ensemble_size, num_epochs) as numpy.
  """
  target_np = np.asarray(target)
  check_supported(**unported)
  device = torch.device(device)
  backend = backends.resolve_backend(backend, device)
  log_noise_init = np.log(np.nanstd(target_np) / 2.0)
  params = init_ensemble(
      config, ensemble_size, seed, float(np.float32(log_noise_init)), device)
  aug_t = torch.as_tensor(
      aug_features, dtype=torch.float32, device=device).T.contiguous()
  y = torch.tensor(target_np, dtype=torch.float32, device=device)
  generator = torch.Generator(device=device).manual_seed(
      stream_seed(seed, PERMUTATION_STREAM))
  params, _, losses = train(
      params, init_opt_state(params), aug_t, y, config,
      likelihoods.LikelihoodDist(distribution), learning_rate, num_epochs,
      prior_weight=prior_weight, backend=backend, batch_size=batch_size,
      permutations=lambda _: random_permutations(
          generator, ensemble_size, y.shape[0]),
      precision=precision,
  )
  return params, losses.cpu().numpy()


# Keys of the random streams a fit derives from its int seed (the
# initialization uses the seed itself).
PERMUTATION_STREAM = 1
VI_STEP_STREAM = 2


def stream_seed(seed: int, stream: int) -> int:
  """A 63-bit seed for random stream `stream` of `seed`: the first word of
  numpy's SeedSequence(seed, spawn_key=(stream,))."""
  state = np.random.SeedSequence(int(seed), spawn_key=(int(stream),))
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
    **unported,
):
  """Fit a MAP/MLE ensemble in `num_splits` sequential splits.

  Returns:
    (params, losses): params leaves (num_particles, ...) on `device`,
    losses (num_particles, num_epochs) as numpy.
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
        device=device, precision=precision, **unported,
    )
    params_splits.append(params_i)
    losses_splits.append(losses_i)
  params = tuple(torch.cat(leaves, dim=0) for leaves in zip(*params_splits))
  return params, np.concatenate(losses_splits, axis=0)
