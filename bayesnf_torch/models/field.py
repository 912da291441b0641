"""The Bayesian neural field (counterpart of `bayesnf_tpu/models/field.py`).

Parameters are the same flat, ordered tuple as in the JAX package
(:func:`param_specs`), so an artifact saved by either package loads into the
other unchanged. Where the JAX package writes a function for one member and
`vmap`s it, the functions here take the member axis written out: every
parameter leaf carries one leading member axis E.

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
from typing import NamedTuple

import numpy as np
import torch

from bayesnf_torch.models import features as feat_lib
from bayesnf_torch.ops import fused_mlp
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
    x_t: (D, N) raw inputs, shared by every member.
    seasonal_t: (2F, N) seasonal features of the time column.

  Returns:
    List of (E, f_g, N) tensors, one per feature group.
  """
  input_scales = torch.tensor(
      config.input_scales, dtype=x_t.dtype, device=x_t.device
  )
  lsa = params[IDX_LOG_SCALE_ADJ]  # (E, D)
  scaled_x = x_t / (input_scales * torch.exp(lsa))[:, :, None]  # (E, D, N)
  e = scaled_x.shape[0]

  groups = [scaled_x]
  for i, degree in enumerate(config.fourier_degrees):
    if degree > 0:
      groups.append(feat_lib.fourier_features_t(scaled_x[:, i], degree))
  if config.seasonal_frequencies:
    groups.append(seasonal_t.expand(e, -1, -1))
  if config.interactions:
    inter_idx = torch.tensor(config.interactions, device=x_t.device)
    groups.append(torch.prod(scaled_x[:, inter_idx, :], dim=2))

  group_scales = special.softplus(params[IDX_FEATURE_SCALES])  # (E, G)
  return [g * group_scales[:, i, None, None] for i, g in enumerate(groups)]


def dense_params(config: FieldConfig, params: tuple):
  """(weights, biases) of the dense layers, input layer first."""
  num_w = config.depth + 1
  weights = tuple(params[IDX_FIRST_DENSE + 2 * l] for l in range(num_w))
  biases = tuple(params[IDX_FIRST_DENSE + 2 * l + 1] for l in range(num_w))
  return weights, biases


def apply_field_t(
    config: FieldConfig,
    params: tuple,
    x_t: torch.Tensor,
    seasonal_t: torch.Tensor,
) -> torch.Tensor:
  """Features-major forward, plain PyTorch: (D, N) inputs -> (E, N)."""
  weights, biases = dense_params(config, params)
  return fused_mlp.fused_field_mlp_t_reference(
      config.depth,
      encode_t_groups(config, params, x_t, seasonal_t),
      weights,
      biases,
      params[IDX_LAYER_SCALES],
      params[IDX_ACTIVATION_LOGIT],
  )
