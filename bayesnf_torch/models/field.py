"""The Bayesian neural field (counterpart of `bayesnf_tpu/models/field.py`).

Parameters are the same flat, ordered tuple as in the JAX package
(:func:`param_specs`), so an artifact saved by either package loads into the
other unchanged. Where the JAX package writes a function for one member and
`vmap`s it, the functions here take the member axis written out: every
parameter leaf carries one leading member axis E.

Data inputs (raw inputs, seasonal rows, targets) are shared by every member,
or stored once per group of E/G consecutive members with a leading axis G
(G = E: one row set per member). Member e reads group e // (E/G), the order
of the JAX package's fused trainer, so the Monte-Carlo draws of a VI member
share its one minibatch without a copy per draw (:func:`grouped`).

Model structure (per member):

  scaled_x = x / (input_scales * exp(log_scale_adjustment))
  groups   = [scaled_x, fourier(scaled_x_i) per dim, seasonal(t), pairwise
              interaction products], each scaled by softplus(group scale)
  h        = concat(groups)
  for each of `depth` hidden layers:
      h = act( softplus(layer_scale) * Dense_width(h / sqrt(fan_in)) )
  out      = softplus(output_scale) * Dense_1(h / sqrt(width))

  act(x)   = sigmoid(w)*elu(x) + (1-sigmoid(w))*tanh(x), learned logit w.
"""

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from bayesnf_torch.models import features as feat_lib
from bayesnf_torch.ops import mixed
from bayesnf_torch.ops import special


class ParamSpec(NamedTuple):
  """Metadata for one entry of the flat parameter tuple.

  Attributes:
    name: stable identifier (used by artifacts and diagnostics).
    shape: per-member array shape.
    prior_loc: location of the elementwise Logistic(loc, 1) prior.
    is_matrix: True for 2-D weight matrices; these are initialized from
      TruncatedNormal(0, 1, -2, 2) while everything else initializes to a
      deterministic constant.
  """

  name: str
  shape: tuple
  prior_loc: float
  is_matrix: bool


@dataclasses.dataclass(frozen=True)
class FieldConfig:
  """Static (hashable) model configuration."""

  width: int
  depth: int
  input_scales: tuple  # (D,) floats; time scale first, 1.0 elsewhere.
  fourier_degrees: tuple  # (D,) ints.
  interactions: tuple  # ((i, j), ...) input-dim index pairs.
  seasonal_frequencies: tuple  # (F,) deduplicated floats.
  seasonal_harmonics: tuple  # (F,) harmonic numbers aligned with frequencies.

  @classmethod
  def create(
      cls,
      *,
      width: int,
      depth: int,
      input_scales,
      fourier_degrees,
      interactions,
      seasonality_periods,
      num_seasonal_harmonics,
  ) -> 'FieldConfig':
    """Build a config from estimator-style model args (host-side)."""
    freqs, harms = feat_lib.seasonal_frequency_table(
        np.asarray(seasonality_periods), np.asarray(num_seasonal_harmonics)
    )
    interactions = np.asarray(interactions, dtype=int).reshape(-1, 2)
    return cls(
        width=int(width),
        depth=int(depth),
        input_scales=tuple(float(s) for s in np.asarray(input_scales)),
        fourier_degrees=tuple(int(d) for d in np.asarray(fourier_degrees)),
        interactions=tuple((int(i), int(j)) for i, j in interactions),
        seasonal_frequencies=tuple(float(f) for f in freqs),
        seasonal_harmonics=tuple(float(h) for h in harms),
    )

  @property
  def num_inputs(self) -> int:
    return len(self.input_scales)

  @property
  def num_seasonal_features(self) -> int:
    return 2 * len(self.seasonal_frequencies)

  @property
  def num_feature_groups(self) -> int:
    """Non-empty feature groups, in encode order."""
    groups = 1  # scaled_x (always non-empty)
    groups += sum(1 for d in self.fourier_degrees if d > 0)
    groups += 1 if self.seasonal_frequencies else 0
    groups += 1 if self.interactions else 0
    return groups

  @property
  def encoded_dim(self) -> int:
    """Width of the encoded feature vector fed to the first dense layer."""
    return (
        self.num_inputs
        + 2 * sum(d for d in self.fourier_degrees if d > 0)
        + self.num_seasonal_features
        + len(self.interactions)
    )


# Indices of the fixed leading entries of the flat params tuple.
IDX_LOG_NOISE_SCALE = 0
IDX_NB_SHAPE_RAW = 1
IDX_ZINB_LOGIT = 2
IDX_LOG_SCALE_ADJ = 3
IDX_FEATURE_SCALES = 4
IDX_ACTIVATION_LOGIT = 5
IDX_LAYER_SCALES = 6
IDX_FIRST_DENSE = 7  # kernels/biases follow: (W_0, b_0, ..., W_out, b_out)


def param_specs(config: FieldConfig) -> tuple[ParamSpec, ...]:
  """The authoritative flat parameter ordering for a field model.

  Layout (one entry per tuple slot), identical to the JAX package's:
    0: log_noise_scale   ()            Normal-likelihood noise (pre-exp).
    1: nb_shape_raw      ()            NB shape (pre-softplus), prior loc -1.5.
    2: zinb_logit        ()            Zero-inflation logit.
    3: log_scale_adjustment (D,)       Learned per-input scale (pre-exp).
    4: feature_scales_raw (G,)         Per-feature-group scale (pre-softplus).
    5: activation_logit  ()            Blend between elu and tanh.
    6: layer_scales_raw  (depth+1,)    Hidden layer scales + output scale
                                       (pre-softplus).
    7..: (W_0, b_0, W_1, b_1, ..., W_out, b_out) dense layers; W_0 is
         (encoded_dim, width), inner layers (width, width), output (width, 1).
  """
  d = config.num_inputs
  specs = [
      ParamSpec('log_noise_scale', (), 0.0, False),
      ParamSpec('nb_shape_raw', (), -1.5, False),
      ParamSpec('zinb_logit', (), 0.0, False),
      ParamSpec('log_scale_adjustment', (d,), 0.0, False),
      ParamSpec('feature_scales_raw', (config.num_feature_groups,), 0.0, False),
      ParamSpec('activation_logit', (), 0.0, False),
      ParamSpec('layer_scales_raw', (config.depth + 1,), 0.0, False),
  ]
  fan_in = config.encoded_dim
  for layer in range(config.depth):
    specs.append(ParamSpec(f'kernel_{layer}', (fan_in, config.width), 0.0, True))
    specs.append(ParamSpec(f'bias_{layer}', (config.width,), 0.0, False))
    fan_in = config.width
  specs.append(ParamSpec('kernel_out', (fan_in, 1), 0.0, True))
  specs.append(ParamSpec('bias_out', (1,), 0.0, False))
  return tuple(specs)


def init_params(
    config: FieldConfig,
    generator: torch.Generator,
    device,
    log_noise_scale_init: float = 0.0,
) -> tuple[torch.Tensor, ...]:
  """Initialize one ensemble member's parameters.

  Weight matrices draw from TruncatedNormal(0, 1, -2, 2); the noise scale
  starts at `log_noise_scale_init`; everything else is 0. The draws come
  from `generator` (which must live on `device`), so they differ from the
  JAX package's threefry draws for the same seed.
  """
  out = []
  for spec in param_specs(config):
    if spec.is_matrix:
      t = torch.empty(spec.shape, dtype=torch.float32, device=device)
      out.append(
          torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator)
      )
    elif spec.name == 'log_noise_scale':
      out.append(
          torch.full(spec.shape, log_noise_scale_init, dtype=torch.float32,
                     device=device)
      )
    else:
      out.append(torch.zeros(spec.shape, dtype=torch.float32, device=device))
  return tuple(out)


def params_from_numpy(
    config: FieldConfig, arrays, ensemble_dims: int, device
) -> tuple[torch.Tensor, ...]:
  """The JAX package's flat parameter tuple (numpy) as float32 tensors.

  Args:
    config: model config the parameters belong to.
    arrays: sequence of arrays in :func:`param_specs` order, each with
      `ensemble_dims` leading ensemble axes (as `params_` in a saved `.npz`).
    ensemble_dims: number of leading ensemble axes.
    device: where the tensors go.

  Raises:
    ValueError: on a wrong leaf count, a leaf whose trailing shape is not its
      spec's, or leaves whose ensemble axes disagree.
  """
  specs = param_specs(config)
  arrays = [np.asarray(a) for a in arrays]
  if len(arrays) != len(specs):
    raise ValueError(
        f'Expected {len(specs)} parameter leaves, got {len(arrays)}.'
    )
  ens_shape = arrays[0].shape[:ensemble_dims]
  for spec, a in zip(specs, arrays):
    if a.shape != ens_shape + spec.shape:
      raise ValueError(
          f'Parameter {spec.name!r} has shape {a.shape}; expected '
          f'{ens_shape + spec.shape} (ensemble axes {ens_shape}).'
      )
  return tuple(
      torch.as_tensor(a.astype(np.float32), device=device) for a in arrays
  )


def seasonal_features_for(config: FieldConfig, x: torch.Tensor) -> torch.Tensor:
  """The (N, 2F) seasonal features for raw inputs `x` (N, D)."""
  return feat_lib.seasonal_features(
      x[:, 0],
      np.asarray(config.seasonal_frequencies),
      np.asarray(config.seasonal_harmonics),
      rescale=True,
  )


def aug_features(config: FieldConfig, x: torch.Tensor) -> torch.Tensor:
  """`[x | seasonal features]`: (N, D) -> (N, D + 2F)."""
  return torch.cat([x, seasonal_features_for(config, x)], dim=-1)


def grouped(t: torch.Tensor, members: int, ndim: int) -> torch.Tensor:
  """A data input as a (G, 1, ...) view for `members` members in G groups.

  Args:
    t: shared (`ndim` dims) or grouped (G leading, G dividing `members`).
    members: the member count E.
    ndim: dims of one row set ((D, N): 2; (N,): 1).

  Returns:
    `t` viewed with two leading axes; a per-member tensor reshaped to
    (G, E/G, ...) broadcasts against it.

  Raises:
    ValueError: if `t` has another rank, or G does not divide `members`.
  """
  if t.ndim == ndim:
    return t[None, None]
  if t.ndim != ndim + 1 or not t.shape[0] or members % t.shape[0]:
    raise ValueError(
        f'A data input of shape {tuple(t.shape)} must be one shared row set '
        f'of {ndim} dims, or have a leading group count that divides the '
        f'member count {members}.'
    )
  return t[:, None]


def encode_raw_t(
    input_scales,
    fourier_degrees,
    interactions,
    lsa: torch.Tensor,
    fs_raw: torch.Tensor,
    x_t: torch.Tensor,
    seasonal_t: torch.Tensor,
) -> list:
  """Features-major encode from the static config values and the two encode
  leaves (the form the K1 training kernel takes).

  Args:
    input_scales: (D,) floats.
    fourier_degrees: (D,) ints.
    interactions: ((i, j), ...) input-dim index pairs.
    lsa: (E, D) log scale adjustments.
    fs_raw: (E, G) pre-softplus feature-group scales.
    x_t: (D, N) raw inputs shared by every member, or (E/rep, D, N) grouped
      (see :func:`grouped`).
    seasonal_t: seasonal features of the time column, (2F, N) or
      (E/rep', 2F, N) (2F may be 0).

  Returns:
    List of (E, f_g, N) tensors, one per non-empty feature group.
  """
  e, d = lsa.shape
  x4 = grouped(x_t, e, 2)  # (G, 1, D, N)
  n = x4.shape[-1]
  scales = torch.tensor(
      tuple(input_scales), dtype=x_t.dtype, device=x_t.device
  )
  divisor = (scales * torch.exp(lsa)).reshape(x4.shape[0], -1, d, 1)
  scaled_x = (x4 / divisor).reshape(e, d, n)
  group_scales = special.softplus(fs_raw)  # (E, G)

  groups = [scaled_x]
  for i, degree in enumerate(fourier_degrees):
    if degree > 0:
      groups.append(feat_lib.fourier_features_t(scaled_x[:, i], degree))
  out = [g * group_scales[:, i, None, None] for i, g in enumerate(groups)]
  if seasonal_t.shape[-2]:
    s4 = grouped(seasonal_t, e, 2)  # (G', 1, 2F, N)
    gs = group_scales[:, len(out)].reshape(s4.shape[0], -1, 1, 1)
    out.append((s4 * gs).reshape(e, -1, n))
  if len(interactions):
    inter_idx = torch.tensor(tuple(interactions), device=x_t.device)
    out.append(torch.prod(scaled_x[:, inter_idx, :], dim=2)
               * group_scales[:, len(out), None, None])
  return out


def encode_t_groups(
    config: FieldConfig,
    params: tuple,
    x_t: torch.Tensor,
    seasonal_t: torch.Tensor,
) -> list:
  """Features-major encode, one tensor per (scaled) feature group.

  Args:
    config: model config.
    params: flat parameter tuple, each leaf with one leading member axis E.
    x_t: (D, N) raw inputs shared by every member, or (E/rep, D, N).
    seasonal_t: (2F, N) seasonal features of the time column, or
      (E/rep, 2F, N).

  Returns:
    List of (E, f_g, N) tensors, one per feature group.
  """
  return encode_raw_t(
      config.input_scales, config.fourier_degrees, config.interactions,
      params[IDX_LOG_SCALE_ADJ], params[IDX_FEATURE_SCALES], x_t, seasonal_t,
  )


def dense_params(config: FieldConfig, params: tuple):
  """(weights, biases) of the dense layers, input layer first."""
  num_w = config.depth + 1
  weights = tuple(params[IDX_FIRST_DENSE + 2 * l] for l in range(num_w))
  biases = tuple(params[IDX_FIRST_DENSE + 2 * l + 1] for l in range(num_w))
  return weights, biases


class _BlendedAct(torch.autograd.Function):
  """w * elu(z) + (1 - w) * tanh(z), whose backward reuses the forward's
  values (elu' = e^z for z < 0, tanh' = 1 - tanh^2), as the JAX package's
  custom JVP does: no transcendental is evaluated twice."""

  @staticmethod
  def forward(ctx, z, w):
    q = torch.exp(torch.clamp(z, max=0.0))
    positive = z > 0
    e = torch.where(positive, z, q - 1.0)
    t = torch.tanh(z)
    ctx.save_for_backward(w, e, t, torch.where(positive, 1.0, q))
    return w * e + (1.0 - w) * t

  @staticmethod
  def backward(ctx, g):
    w, e, t, de = ctx.saved_tensors
    dz = (w * de + (1.0 - w) * (1.0 - t * t)) * g
    dw = None
    if ctx.needs_input_grad[1]:
      dw = ((e - t) * g).sum_to_size(w.shape)
    return dz, dw


def blended_act(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """The field's activation; `w` broadcasts against `z`."""
  return _BlendedAct.apply(z, w)


def mlp_t(depth, h0_groups, weights, biases, scales_raw, logit,
          precision='f32', k1_sites=False) -> torch.Tensor:
  """Features-major field MLP, plain PyTorch: one matrix product per layer.

  Args:
    depth: hidden layers.
    h0_groups: sequence of (E, f_g, N) feature-group tensors.
    weights: depth + 1 tensors (E, fan_in, fan_out); the last has fan_out 1.
    biases: depth + 1 tensors (E, fan_out).
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.
    precision: 'f32' | 'highest' (`torch.matmul`) | 'bf16'
      (`mixed.matmul_bf16` on every layer, as the JAX package's XLA path).
    k1_sites: under 'bf16', round where the features-major kernels (K1,
      K2 and its backward) round instead: a weight gradient with one column
      (the output layer's) stays fp32.

  Returns:
    (E, N) predictions.
  """
  h = torch.cat(tuple(h0_groups), dim=1)
  s = special.softplus(scales_raw)
  w = torch.sigmoid(logit)[:, None, None]
  for l in range(depth + 1):
    z = mixed.matmul(
        weights[l].transpose(1, 2), h * (1.0 / math.sqrt(h.shape[1])),
        precision, exact_da=k1_sites and weights[l].shape[-1] == 1)
    z = s[:, l, None, None] * (z + biases[l][:, :, None])
    if l < depth:
      h = blended_act(z, w)
  return z[:, 0, :]


def apply_field_t(
    config: FieldConfig,
    params: tuple,
    x_t: torch.Tensor,
    seasonal_t: torch.Tensor,
    precision: str = 'f32',
) -> torch.Tensor:
  """Features-major forward, plain PyTorch: (D, N) shared or (E/rep, D, N)
  grouped inputs -> (E, N); the dense layers' products at `precision`
  (`mlp_t`)."""
  weights, biases = dense_params(config, params)
  return mlp_t(
      config.depth,
      encode_t_groups(config, params, x_t, seasonal_t),
      weights,
      biases,
      params[IDX_LAYER_SCALES],
      params[IDX_ACTIVATION_LOGIT],
      precision,
  )


def encode(
    config: FieldConfig,
    params: tuple,
    x: torch.Tensor,
    seasonal: torch.Tensor,
) -> torch.Tensor:
  """Row-major encode: the JAX package's `encode` with the member axis
  written out.

  Args:
    config: model config.
    params: flat parameter tuple, each leaf with one leading member axis E.
    x: (N, D) raw inputs shared by every member, or (G, N, D) grouped (see
      :func:`grouped`; G = E: one row set per member).
    seasonal: (N, 2F) seasonal features of the time column, or (G', N, 2F).

  Returns:
    (E, N, encoded_dim) encoded features.
  """
  lsa = params[IDX_LOG_SCALE_ADJ]
  e, d = lsa.shape
  x4 = grouped(x, e, 2)  # (G, 1, N, D)
  n = x4.shape[-2]
  scales = torch.tensor(
      tuple(config.input_scales), dtype=x.dtype, device=x.device
  )
  divisor = (scales * torch.exp(lsa)).reshape(x4.shape[0], -1, 1, d)
  scaled_x = (x4 / divisor).reshape(e, n, d)
  group_scales = special.softplus(params[IDX_FEATURE_SCALES])  # (E, G)

  groups = [scaled_x]
  for i, degree in enumerate(config.fourier_degrees):
    if degree > 0:
      groups.append(feat_lib.fourier_features(scaled_x[..., i], degree))
  out = [g * group_scales[:, i, None, None] for i, g in enumerate(groups)]
  if config.seasonal_frequencies:
    s4 = grouped(seasonal, e, 2)  # (G', 1, N, 2F)
    gs = group_scales[:, len(out)].reshape(s4.shape[0], -1, 1, 1)
    out.append((s4 * gs).reshape(e, n, -1))
  if config.interactions:
    inter_idx = torch.tensor(tuple(config.interactions), device=x.device)
    out.append(torch.prod(scaled_x[:, :, inter_idx], dim=-1)
               * group_scales[:, len(out), None, None])
  return torch.cat(out, dim=-1)


def mlp(depth, h0, weights, biases, scales_raw, logit,
        precision='f32') -> torch.Tensor:
  """Row-major field MLP, plain PyTorch: one matrix product per layer (the
  plain version of the K4a kernel, `ops/fused_mlp.fused_field_mlp`).

  Args:
    depth: hidden layers.
    h0: (E, N, F) encoded features.
    weights: depth + 1 tensors (E, fan_in, fan_out); the last has fan_out 1.
    biases: depth + 1 tensors (E, fan_out).
    scales_raw: (E, depth + 1) pre-softplus layer scales.
    logit: (E,) activation logits.
    precision: 'f32' | 'highest' (`torch.matmul`) | 'bf16'
      (`mixed.matmul_bf16`), rounded where the row-major Pallas kernels
      round: a product whose result has a last dimension of 1 stays fp32.
      So the output layer's forward h @ W_out and its weight gradient keep
      fp32, its dv @ W_out^T rounds, and with one encoded feature so does
      nothing of the first layer's d h0.

  Returns:
    (E, N) predictions.
  """
  s = special.softplus(scales_raw)
  w = torch.sigmoid(logit)[:, None, None]
  h = h0
  for l in range(depth + 1):
    fan_in, fan_out = weights[l].shape[-2:]
    z = mixed.matmul(
        h * (1.0 / math.sqrt(fan_in)), weights[l], precision,
        exact_da=fan_in == 1, exact_out=fan_out == 1, exact_db=fan_out == 1)
    z = s[:, l, None, None] * (z + biases[l][:, None, :])
    if l < depth:
      h = blended_act(z, w)
  return z[..., 0]


def apply_field(
    config: FieldConfig,
    params: tuple,
    x: torch.Tensor,
    seasonal: torch.Tensor,
    precision: str = 'f32',
) -> torch.Tensor:
  """Row-major forward, plain PyTorch: (N, D) shared or (G, N, D) grouped
  inputs -> (E, N), as `jax.vmap` of the JAX package's `apply_field` over
  members. Under 'bf16' the products round where the row-major kernels
  round (:func:`mlp`), where the JAX function's XLA path rounds them all."""
  weights, biases = dense_params(config, params)
  return mlp(
      config.depth,
      encode(config, params, x, seasonal),
      weights,
      biases,
      params[IDX_LAYER_SCALES],
      params[IDX_ACTIVATION_LOGIT],
      precision,
  )


def scatter_fused_train_grads(
    config: FieldConfig, dlsa, dfs, dws, dbs, dscales, dlogit, dobs
) -> list:
  """Map `ops.fused_mlp.fused_train` gradient outputs onto param slots.

  The kernel returns (losses, dlsa, dfs, dweights, dbiases, dscales,
  dlogit, dobs); this is the one place that couples that output order to
  the flat parameter layout. `dobs` columns are (log_noise_scale,
  nb_shape_raw, zinb_logit).
  """
  grads = [None] * len(param_specs(config))
  grads[IDX_LOG_NOISE_SCALE] = dobs[..., 0]
  grads[IDX_NB_SHAPE_RAW] = dobs[..., 1]
  grads[IDX_ZINB_LOGIT] = dobs[..., 2]
  grads[IDX_LOG_SCALE_ADJ] = dlsa
  grads[IDX_FEATURE_SCALES] = dfs
  grads[IDX_ACTIVATION_LOGIT] = dlogit
  grads[IDX_LAYER_SCALES] = dscales
  for l in range(config.depth + 1):
    grads[IDX_FIRST_DENSE + 2 * l] = dws[l]
    grads[IDX_FIRST_DENSE + 2 * l + 1] = dbs[l]
  return grads
