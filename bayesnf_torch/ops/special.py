"""Special functions of the serving and training paths (counterpart of
`bayesnf_tpu/ops/special.py`): softplus and its inverse, the Normal,
Logistic and Negative Binomial densities, the Stirling series that K1
evaluates in its count-likelihood epilogue, and the regularized incomplete
beta function behind the Negative Binomial CDF.
"""

import math

import torch

# Iteration cap of the incomplete beta continued fraction in float32 (XLA's
# `regularized_incomplete_beta_impl`), and how often the loop asks the
# device whether every lane has converged.
BETAINC_MAX_ITERATIONS = 200
BETAINC_CHECK_EVERY = 8


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


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
  """log(sigmoid(x)) as `jax.nn.log_sigmoid` computes it: -softplus(-x)."""
  return -softplus(-x)


def gammaln_stirling(x) -> torch.Tensor:
  """log Gamma(x) for x > 0 by a shift-by-6 recurrence and a Stirling series.

  The form K1 evaluates in its count epilogue (only log, mul and add),
  operation for operation as the JAX package writes it: the recurrence is
  evaluated at min(x, 1e6), so that its products never overflow, and above
  1e6 the unshifted series is selected. Relative error below ~3e-4 in
  float32.
  """
  x = torch.as_tensor(x, dtype=torch.float32)
  xs = torch.clamp(x, max=1e6)
  p0 = xs * (xs + 1.0)
  p1 = (xs + 2.0) * (xs + 3.0)
  p2 = (xs + 4.0) * (xs + 5.0)
  z = xs + 6.0
  zi = 1.0 / z
  zi2 = zi * zi
  series = zi * (
      0.08333333333333333  # 1/12
      + zi2 * (-0.002777777777777778  # -1/360
               + zi2 * 0.0007936507936507937)  # 1/1260
  )
  stirling = (z - 0.5) * torch.log(z) - z + 0.9189385332046727 + series
  shifted = stirling - torch.log(p0) - torch.log(p1) - torch.log(p2)
  x1 = torch.clamp(x, min=1.0)
  direct = ((x - 0.5) * torch.log(x1) - x + 0.9189385332046727
            + 1.0 / (12.0 * x1))
  return torch.where(x > 1e6, direct, shifted)


def digamma_stirling(x) -> torch.Tensor:
  """digamma(x) for x > 0 by a shift-by-6 recurrence and an asymptotic
  series, as K1 evaluates it. Absolute error below ~1e-6 in float32 for x
  in (0, ~1e7]."""
  x = torch.as_tensor(x, dtype=torch.float32)
  corr = (
      1.0 / x + 1.0 / (x + 1.0) + 1.0 / (x + 2.0)
      + 1.0 / (x + 3.0) + 1.0 / (x + 4.0) + 1.0 / (x + 5.0)
  )
  z = x + 6.0
  zi = 1.0 / z
  zi2 = zi * zi
  series = zi2 * (
      0.08333333333333333  # 1/12
      + zi2 * (-0.008333333333333333  # -1/120
               + zi2 * 0.003968253968253968)  # 1/252
  )
  return torch.log(z) - 0.5 * zi - series - corr


def nb_log_prob(x, total_count, logits) -> torch.Tensor:
  """Elementwise Negative Binomial log-pmf (TFP's parametrization):

      lgamma(r + x) - lgamma(1 + x) - lgamma(r)
      + r * log_sigmoid(-logits) + x * log_sigmoid(logits),  r = total_count.
  """
  x = torch.as_tensor(x, dtype=torch.float32, device=logits.device)
  r = total_count
  return (
      torch.lgamma(r + x)
      - torch.lgamma(1.0 + x)
      - torch.lgamma(r)
      + r * log_sigmoid(-logits)
      + x * log_sigmoid(logits)
  )


def nb_mean(total_count, logits) -> torch.Tensor:
  """Mean of the Negative Binomial: total_count * exp(logits)."""
  return total_count * torch.exp(logits)


def nb_variance(total_count, logits) -> torch.Tensor:
  """Variance of the Negative Binomial: mean / sigmoid(-logits)."""
  return nb_mean(total_count, logits) / torch.sigmoid(-logits)


def nb_cdf(x, total_count, logits) -> torch.Tensor:
  """CDF of the Negative Binomial at real-valued x.

  P(X <= x) = I_{sigmoid(-logits)}(total_count, 1 + x), continuous in x (no
  floor), as TFP's and the JAX package's: the count quantile search roots
  this continuous CDF and then takes the ceiling, which gives the exact
  integer quantile, where a floored step CDF would root just above the
  integer and ceil one too high. At integer x both agree. Negative x gives 0.
  """
  x = torch.as_tensor(x, dtype=torch.float32, device=logits.device)
  safe_x = torch.clamp(x, min=0.0)
  cdf = betainc(total_count, 1.0 + safe_x, torch.sigmoid(-logits))
  return torch.where(x < 0, torch.zeros_like(cdf), cdf)


def _betainc_numerator(iteration: int, a, b, x, a_plus_b):
  """Partial numerator `iteration` of the continued fraction (DLMF 8.17.23),
  with XLA's order of operations; the first is one."""
  if iteration == 1:
    return torch.ones_like(x)
  m = float((iteration - 1) // 2)
  if iteration % 2 == 0:
    if m == 0:
      return -a_plus_b * x / (a + 1.0)
    return -(a + m) * (a_plus_b + m) * x / (
        (a + 2.0 * m) * (a + 2.0 * m + 1.0))
  return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def betainc(a, b, x) -> torch.Tensor:
  """Regularized incomplete beta function I_x(a, b), float32.

  PyTorch has none, so this follows the XLA lowering that
  `jax.scipy.special.betainc` uses (`regularized_incomplete_beta_impl`):

  - where x >= (a + 1) / (a + b + 2) the symmetry I_x(a, b) = 1 - I_{1-x}(b,
    a) swaps the arguments, so the continued fraction converges fast;
  - the fraction (DLMF 8.17.22) is evaluated by the Lentz-Thompson-Barnett
    algorithm, every lane iterating until no lane's step changes the value by
    eps/2 or more, at most 199 steps; the loop asks the device every
    `BETAINC_CHECK_EVERY` steps whether it may stop, and the steps taken
    past that point leave the value as it was;
  - the edge cases: a = 0 (or b = inf) gives 1 for x > 0 and 0 at x = 0; b =
    0 (or a = inf) gives 0 for x < 1 and 1 at x = 1; a < 0, b < 0, x outside
    [0, 1], a = b = 0 or a NaN input give NaN.

  Args are broadcast against each other.
  """
  device = next((t.device for t in (a, b, x) if isinstance(t, torch.Tensor)),
                None)
  a, b, x = torch.broadcast_tensors(*[
      torch.as_tensor(t, dtype=torch.float32, device=device)
      for t in (a, b, x)])
  finfo = torch.finfo(torch.float32)
  inf = math.inf
  a_is_zero = (a == 0) | (b == inf)
  b_is_zero = (b == 0) | (a == inf)
  x_is_zero = x == 0
  x_is_one = x == 1
  is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
  result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
  result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
  result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                   | (a_is_zero & b_is_zero) | is_nan)

  converges_rapidly = x < (a + 1.0) / (a + b + 2.0)
  a, b = torch.where(converges_rapidly, a, b), torch.where(
      converges_rapidly, b, a)
  x = torch.where(converges_rapidly, x, 1.0 - x)

  # Lentz-Thompson-Barnett: the 0th partial denominator is 0, every later
  # one 1; c, d and h start from `small` (|0| < small), d from 0.
  small = finfo.eps / 2
  threshold = finfo.eps / 2
  a_plus_b = a + b
  h = torch.full_like(x, small)
  c = h
  d = torch.zeros_like(x)
  running = torch.ones((), dtype=torch.bool, device=x.device)
  for iteration in range(1, BETAINC_MAX_ITERATIONS):
    num = _betainc_numerator(iteration, a, b, x, a_plus_b)
    c = 1.0 + num / c
    c = torch.where(torch.abs(c) < small, small, c)
    d = 1.0 + num * d
    d = torch.reciprocal(torch.where(torch.abs(d) < small, small, d))
    delta = c * d
    h = torch.where(running, h * delta, h)
    running = running & (torch.abs(delta - 1.0) >= threshold).any()
    if iteration % BETAINC_CHECK_EVERY == 0 and not bool(running):
      break

  # For very small a, a * Gamma(a) = Gamma(a + 1) -> 1 avoids dividing by 0.
  lbeta_small_a = torch.lgamma(b) - torch.lgamma(a_plus_b)
  lbeta = torch.lgamma(a) + lbeta_small_a
  log1m_x = torch.log1p(-x)
  factor = torch.where(
      a < finfo.tiny * 2,
      torch.exp(log1m_x * b - lbeta_small_a),
      torch.exp(torch.log(x) * a + log1m_x * b - lbeta) / a)
  result = h * factor
  result = torch.where(converges_rapidly, result, 1.0 - result)
  result = torch.where(result_is_zero, 0.0, result)
  result = torch.where(result_is_one, 1.0, result)
  return torch.where(result_is_nan, math.nan, result)
