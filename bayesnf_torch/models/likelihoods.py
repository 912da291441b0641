"""Observation models (counterpart of `bayesnf_tpu/models/likelihoods.py`).

- NORMAL: y ~ Normal(pred, 0.01 + exp(log_noise_scale)).
- NB: mean = softplus(pred), shape = softplus(nb_shape_raw);
  total_count = 1/shape, logits = -log(shape) - log(mean).
- ZINB: NB plus inflated-zero probability sigmoid(zinb_logit).

Only the forecast parameters are here (what predict needs); the
log-likelihoods arrive with training.
"""

import enum

import torch

from bayesnf_torch.models import field as field_lib
from bayesnf_torch.ops import special


class LikelihoodDist(enum.Enum):
  NORMAL = 'NORMAL'
  NB = 'NB'
  ZINB = 'ZINB'


def forecast_params(
    distribution: LikelihoodDist, params: tuple, pred: torch.Tensor
) -> tuple[torch.Tensor, ...]:
  """Raw distribution parameters per observation model.

  `params` leaves carry a leading member axis E and `pred` is (E, N):

  - NORMAL -> (loc (E, N), scale (E,))
  - NB     -> (total_count (E,), logits (E, N))
  - ZINB   -> (total_count (E,), logits (E, N), inflated_loc_probs (E, N))
  """
  if distribution == LikelihoodDist.NORMAL:
    scale = 0.01 + torch.exp(params[field_lib.IDX_LOG_NOISE_SCALE])
    return (pred, scale)

  shape = special.softplus(params[field_lib.IDX_NB_SHAPE_RAW])
  total_count = 1.0 / shape
  logits = -torch.log(shape)[:, None] - special.log_softplus(pred)

  if distribution == LikelihoodDist.NB:
    return (total_count, logits)
  if distribution == LikelihoodDist.ZINB:
    pi = torch.sigmoid(params[field_lib.IDX_ZINB_LOGIT])
    return (total_count, logits, pi[:, None] * torch.ones_like(logits))
  raise AssertionError(f'Unknown likelihood distribution: {distribution}')
