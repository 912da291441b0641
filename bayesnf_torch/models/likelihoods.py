"""Observation models (counterpart of `bayesnf_tpu/models/likelihoods.py`).

- NORMAL: y ~ Normal(pred, 0.01 + exp(log_noise_scale)).
- NB: mean = softplus(pred), shape = softplus(nb_shape_raw);
  total_count = 1/shape, logits = -log(shape) - log(mean).
- ZINB: NB plus inflated-zero probability sigmoid(zinb_logit).

The log-likelihood of a batch is the sum over its rows. Every function here
takes targets shared by every member, or grouped (`field.grouped`), and
never copies them per member.
"""

import enum

import torch

from bayesnf_torch.models import field as field_lib
from bayesnf_torch.ops import special


class LikelihoodDist(enum.Enum):
  NORMAL = 'NORMAL'
  NB = 'NB'
  ZINB = 'ZINB'


def log_likelihood(
    distribution: LikelihoodDist,
    params: tuple,
    pred: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
  """Summed log-likelihood of observations `y` given predictions `pred`.

  Args:
    distribution: observation model.
    params: flat parameter tuple, each leaf with a leading member axis E;
      only the three leading scalars (log_noise_scale, nb_shape_raw,
      zinb_logit) are read.
    pred: (E, B) field predictions.
    y: (B,) observed targets shared by every member, or (E/rep, B) grouped
      (`field.grouped`).
    weights: optional (B,) per-observation weights.

  Returns:
    (E,) sums over the rows of the (weighted) elementwise log-probs.
  """
  if distribution == LikelihoodDist.NORMAL:
    return normal_log_likelihood(
        params[field_lib.IDX_LOG_NOISE_SCALE], pred, y, weights)
  e, b = pred.shape
  y3 = field_lib.grouped(y, e, 1)[:, 0, None]  # (G, 1, B)
  groups = y3.shape[0]

  def per_group(t):  # (E,) -> (G, E/G, 1)
    return t.reshape(groups, -1, 1)

  shape = special.softplus(params[field_lib.IDX_NB_SHAPE_RAW])
  # log(softplus(pred)) computed stably (no -inf or NaN for very negative
  # pred).
  logits = -torch.log(per_group(shape)) - special.log_softplus(
      pred.reshape(groups, -1, b))
  lp = special.nb_log_prob(y3, per_group(1.0 / shape), logits)
  if distribution == LikelihoodDist.ZINB:
    zinb_logit = per_group(params[field_lib.IDX_ZINB_LOGIT])
    nonzero_lp = special.log_sigmoid(-zinb_logit) + lp
    # At y == 0 the density is pi + (1 - pi) NB(0); elsewhere (1 - pi) NB(y).
    lp = torch.where(
        y3 == 0,
        torch.logaddexp(special.log_sigmoid(zinb_logit), nonzero_lp),
        nonzero_lp)
  elif distribution != LikelihoodDist.NB:
    raise AssertionError(f'Unknown likelihood distribution: {distribution}')
  return _weighted_sum(lp.reshape(e, b), weights)


def _weighted_sum(lp, weights):
  if weights is not None:
    lp = lp * weights
  return lp.sum(dim=-1)


def normal_log_likelihood(log_noise_scale, pred, y, weights=None):
  """(E,) NORMAL log-likelihood sums, scale 0.01 + exp(log_noise_scale (E,)),
  for `log_likelihood`'s pred, y and weights."""
  e, b = pred.shape
  y3 = field_lib.grouped(y, e, 1)[:, 0, None]  # (G, 1, B)
  scale = 0.01 + torch.exp(log_noise_scale)
  lp = special.normal_log_prob(
      y3, pred.reshape(y3.shape[0], -1, b),
      scale.reshape(y3.shape[0], -1, 1)).reshape(e, b)
  return _weighted_sum(lp, weights)


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
