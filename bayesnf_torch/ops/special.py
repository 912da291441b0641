"""Special functions the NORMAL serving path needs (counterpart of
`bayesnf_tpu/ops/special.py`).

Only what predict uses is here; the count-model functions (incomplete beta,
Stirling series) arrive with the NB/ZINB slice.
"""

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
  """log(1 + e^x) as `jax.nn.softplus` computes it: `logaddexp(x, 0)`.

  `torch.nn.functional.softplus` switches to the identity above x = 20;
  this form has no threshold, so both packages round alike everywhere.
  """
  return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_softplus(x: torch.Tensor) -> torch.Tensor:
  """Numerically stable log(softplus(x)).

  For x << 0, softplus(x) ~= e^x underflows in f32 around x < -88, so
  log(softplus(x)) would be -inf; there log(softplus(x)) ~= x to within e^x.
  The unselected branch's input is clamped so it stays finite.
  """
  safe_x = torch.clamp(x, min=-20.0)
  return torch.where(x < -20.0, x, torch.log(softplus(safe_x)))


def normal_cdf(x, loc=0.0, scale=1.0) -> torch.Tensor:
  return torch.special.ndtr((x - loc) / scale)


def normal_quantile(q, loc: torch.Tensor, scale) -> torch.Tensor:
  q = torch.as_tensor(q, dtype=loc.dtype, device=loc.device)
  return loc + scale * torch.special.ndtri(q)
