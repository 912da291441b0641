"""Ensemble MAP / MLE trainer, full batch, one device (counterpart of the
full-batch part of `bayesnf_tpu/inference/map.py`).

- loss = -(loglik * N/B + prior_weight * prior_log_prob); MLE is
  prior_weight == 0. Full batch means B == N.
- init: every member from `field.init_params`, drawn by one CPU
  `torch.Generator` seeded with the int `seed` (so a seed starts the same
  ensemble on every device); the noise scale starts at log(nanstd(y) / 2),
  computed in numpy as the JAX package computes it.
- Adam as optax computes it (`adam_update`), over leaves with a leading
  member axis E. The recorded loss of an epoch is the loss before its
  (single) update.
- Each step's losses and gradients come from one of two backends
  (`backends.py`): 'kernel' makes one `fused_mlp.fused_train` call over all
  rows (K1 on CUDA) and adds the prior outside it; 'torch' runs autograd
  through `field.apply_field_t` and `likelihoods.log_likelihood` in
  `ROW_CHUNK`-row chunks, summed after the prior, as the JAX package's
  chunked gradient accumulation does.
- `fit_map` keeps the `num_splits` host loop over ensemble chunks.

Not ported yet, and raising NotImplementedError: minibatch training, NB and
ZINB, checkpoints, host streaming, precision other than 'f32' and a device
mesh (ROADMAP.md, queue 1).
"""

from typing import NamedTuple

import numpy as np
import torch

from bayesnf_torch.inference import backends
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.models import priors
from bayesnf_torch.ops import fused_mlp

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
  if prior_weight == 0.0:
    return (torch.zeros_like(params[0]).reshape(-1),
            [torch.zeros_like(p) for p in params])
  leaves = [p.detach().requires_grad_(True) for p in params]
  with torch.enable_grad():
    losses = -prior_weight * priors.prior_log_prob(config, leaves)
    grads = torch.autograd.grad(losses.sum(), leaves)
  return losses.detach(), list(grads)


def make_losses_and_grads(config, distribution, prior_weight, backend):
  """The per-step `(params, aug_t, target) -> (losses (E,), grads)` of a
  full-batch fit on `backend` ('torch' or 'kernel', resolved)."""
  d = config.num_inputs
  lik_scale = 1.0  # data_size / batch_size, full batch.

  def torch_losses_and_grads(params, aug_t, target):
    losses, grads = _prior_losses_and_grads(config, params, prior_weight)
    leaves = [p.detach().requires_grad_(True) for p in params]
    for lo in range(0, aug_t.shape[1], ROW_CHUNK):
      chunk = aug_t[:, lo : lo + ROW_CHUNK]
      with torch.enable_grad():
        pred = field_lib.apply_field_t(config, leaves, chunk[:d], chunk[d:])
        chunk_losses = -lik_scale * likelihoods.log_likelihood(
            distribution, leaves, pred, target[lo : lo + ROW_CHUNK]
        )
        # NORMAL leaves the NB/ZINB scalars out of the graph: zero grads.
        chunk_grads = torch.autograd.grad(
            chunk_losses.sum(), leaves, allow_unused=True,
            materialize_grads=True)
      losses = losses + chunk_losses.detach()
      grads = [g + cg for g, cg in zip(grads, chunk_grads)]
    return losses, grads

  def kernel_losses_and_grads(params, aug_t, target):
    weights, biases = field_lib.dense_params(config, params)
    obs_raw = torch.stack(
        [params[field_lib.IDX_LOG_NOISE_SCALE],
         params[field_lib.IDX_NB_SHAPE_RAW],
         params[field_lib.IDX_ZINB_LOGIT]], dim=-1)
    losses, dlsa, dfs, dws, dbs, dscales, dlogit, dobs = fused_mlp.fused_train(
        distribution.value, config.depth, lik_scale, config.input_scales,
        config.fourier_degrees, config.interactions, aug_t[:d], aug_t[d:],
        weights, biases, params[field_lib.IDX_LOG_SCALE_ADJ],
        params[field_lib.IDX_FEATURE_SCALES],
        params[field_lib.IDX_LAYER_SCALES],
        params[field_lib.IDX_ACTIVATION_LOGIT], obs_raw, target,
    )
    grads = field_lib.scatter_fused_train_grads(
        config, dlsa, dfs, dws, dbs, dscales, dlogit, dobs)
    if prior_weight != 0.0:
      prior_losses, prior_grads = _prior_losses_and_grads(
          config, params, prior_weight)
      losses = losses + prior_losses
      grads = [g + pg for g, pg in zip(grads, prior_grads)]
    return losses, grads

  if backend == 'kernel':
    return kernel_losses_and_grads
  if backend == 'torch':
    return torch_losses_and_grads
  raise ValueError(f'Unresolved backend: {backend!r}')


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
):
  """`num_epochs` full-batch Adam steps from `params` and `opt_state`.

  Args:
    params: flat parameter tuple, each leaf with a leading member axis E.
    opt_state: Adam state of `params` (`init_opt_state` for a new fit).
    aug_t: (D + 2F, N) inputs with seasonal features, features-major.
    target: (N,) targets.
    config: model config.
    distribution: observation model (NORMAL).
    learning_rate: Adam learning rate.
    num_epochs: steps (one per epoch, full batch).
    prior_weight: prior multiplier (0 == MLE).
    backend: 'torch' or 'kernel' (resolved).

  Returns:
    (params, opt_state, losses): losses (E, num_epochs) on the parameters'
    device, each the loss before that epoch's update.
  """
  losses_and_grads = make_losses_and_grads(
      config, distribution, prior_weight, backend)
  params = tuple(params)
  history = []
  for _ in range(int(num_epochs)):
    losses, grads = losses_and_grads(params, aug_t, target)
    updates, opt_state = adam_update(grads, opt_state, learning_rate)
    params = tuple(p + u for p, u in zip(params, updates))
    history.append(losses)
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


def check_supported(distribution, batch_size, data_size, mesh=None,
                    checkpoint_dir=None, checkpoint_every=None,
                    precision='f32', stream_chunk_steps=None,
                    stream_member_remix=False):
  """Raises NotImplementedError for what the port does not train yet."""
  if likelihoods.LikelihoodDist(distribution) != (
      likelihoods.LikelihoodDist.NORMAL):
    raise NotImplementedError(
        f'Training the {likelihoods.LikelihoodDist(distribution).value} '
        'model is not ported to PyTorch yet (ROADMAP.md, queue 1 item 10).'
    )
  if batch_size is not None and batch_size < data_size:
    raise NotImplementedError(
        f'Minibatch training (batch_size={batch_size} < {data_size} rows) is '
        'not ported to PyTorch yet (ROADMAP.md, queue 1 item 7; its kernel '
        'path needs per-member inputs, queue 2 K1 stage 3).'
    )
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
  if precision != 'f32':
    raise NotImplementedError(
        f"precision={precision!r} is not ported to PyTorch yet (ROADMAP.md, "
        "queue 2 K1 stage 5); the port trains in 'f32'."
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
    **unported,
):
  """Train `ensemble_size` independent MAP/MLE members, full batch.

  Args:
    aug_features: (N, D + 2F) training inputs with seasonal features
      appended (`field.aug_features`), numpy or a tensor.
    target: (N,) training targets (numpy).
    config: model config.
    distribution: observation model.
    ensemble_size: members to train.
    learning_rate: Adam learning rate.
    num_epochs: epochs (one full-batch step each).
    seed: int seed of the initialization.
    batch_size: None or N (full batch).
    prior_weight: prior multiplier (0 == MLE).
    backend: 'auto' | 'torch' | 'kernel' (`backends.resolve_backend`).
    device: where the fit runs.
    **unported: the JAX package's mesh, checkpoint, precision and
      streaming arguments; anything but their defaults raises.

  Returns:
    (params, losses): params with leading member axis (ensemble_size, ...)
    on `device`; losses (ensemble_size, num_epochs) as numpy.
  """
  target_np = np.asarray(target)
  data_size = int(target_np.shape[0])
  check_supported(distribution, batch_size, data_size, **unported)
  device = torch.device(device)
  backend = backends.resolve_backend(backend, device)
  log_noise_init = np.log(np.nanstd(target_np) / 2.0)
  params = init_ensemble(
      config, ensemble_size, seed, float(np.float32(log_noise_init)), device)
  aug_t = torch.as_tensor(
      aug_features, dtype=torch.float32, device=device).T.contiguous()
  y = torch.tensor(target_np, dtype=torch.float32, device=device)
  params, _, losses = train(
      params, init_opt_state(params), aug_t, y, config,
      likelihoods.LikelihoodDist(distribution), learning_rate, num_epochs,
      prior_weight=prior_weight, backend=backend,
  )
  return params, losses.cpu().numpy()


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
        device=device, **unported,
    )
    params_splits.append(params_i)
    losses_splits.append(losses_i)
  params = tuple(torch.cat(leaves, dim=0) for leaves in zip(*params_splits))
  return params, np.concatenate(losses_splits, axis=0)
