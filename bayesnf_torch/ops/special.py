"""Special functions of the NORMAL serving and training paths, MAP and VI
(counterpart of `bayesnf_tpu/ops/special.py`).

The count-model functions (incomplete beta, Stirling series) arrive with the
NB/ZINB slice.
"""

import math

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
  """log(1 + e^x) as `jax.nn.softplus` computes it: `logaddexp(x, 0)`.

  `torch.nn.functional.softplus` switches to the identity above x = 20;
  this form has no threshold, so both packages round alike everywhere.
  """
  return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
  """Inverse of softplus: x such that log(1 + e^x) = y.

  Stable form: x = y + log(1 - e^(-y)) = y + log(-expm1(-y)).
  """
  return y + torch.log(-torch.expm1(-y))


def log_softplus(x: torch.Tensor) -> torch.Tensor:
  """Numerically stable log(softplus(x)).

  For x << 0, softplus(x) ~= e^x underflows in f32 around x < -88, so
  log(softplus(x)) would be -inf; there log(softplus(x)) ~= x to within e^x.
  The unselected branch's input is clamped so it stays finite.
  """
  safe_x = torch.clamp(x, min=-20.0)
  return torch.where(x < -20.0, x, torch.log(softplus(safe_x)))


def logistic_log_prob(x: torch.Tensor, loc=0.0, scale=1.0) -> torch.Tensor:
  """Elementwise log-density of Logistic(loc, scale).

  log p(x) = -z - 2*softplus(-z) - log(scale), z = (x - loc)/scale.
  """
  z = (x - loc) / scale
  return -z - 2.0 * softplus(-z) - math.log(scale)


def normal_log_prob(x, loc: torch.Tensor, scale) -> torch.Tensor:
  """Elementwise log-density of Normal(loc, scale).

  log(2 pi) is taken in float32, as the JAX package takes it.
  """
  z = (x - loc) / scale
  log_2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=loc.dtype))
  return -0.5 * z * z - 0.5 * log_2pi.item() - torch.log(scale)


def normal_cdf(x, loc=0.0, scale=1.0) -> torch.Tensor:
  return torch.special.ndtr((x - loc) / scale)


def normal_quantile(q, loc: torch.Tensor, scale) -> torch.Tensor:
  q = torch.as_tensor(q, dtype=loc.dtype, device=loc.device)
  return loc + scale * torch.special.ndtri(q)
