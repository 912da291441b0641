"""Ensemble-mixture quantiles (counterpart of
`bayesnf_tpu/inference/quantiles.py`).

- NORMAL, exact: root of `mean_ensemble CDF(x) - q` on the bracket
  [min(mu) - 5 max(sigma), max(mu) + 5 max(sigma)], value tolerance 1e-5,
  by a vectorized Chandrupatla search with a fixed 60 iterations and no
  data-dependent branches (converged lanes are frozen), as in the JAX
  package.
- NORMAL, approximate: a moment-matched single Normal.
- NB and ZINB: the same search on the mixture's continuous CDF over
  [0, max mean + 1.1 max stddev / sqrt(1 - q)], then the ceiling, and 0
  where the mixture's P(0) already exceeds q.
"""

import torch

from bayesnf_torch.ops import special


def find_root_chandrupatla(
    f,
    low,
    high,
    value_tolerance: float = 1e-5,
    position_tolerance: float = 1e-8,
    max_iterations: int = 60,
) -> torch.Tensor:
  """Vectorized Chandrupatla root search over independent lanes.

  Args:
    f: maps a tensor of positions to same-shape function values.
    low: lower bracket (0-d or broadcastable tensor).
    high: upper bracket (0-d or broadcastable tensor).
    value_tolerance: stop lanes whose best |f| falls below this.
    position_tolerance: stop lanes whose bracket is this small.
    max_iterations: fixed iteration count.

  Returns:
    Tensor of estimated roots (the bracket endpoint with smallest |f|).
  """
  low = torch.as_tensor(low, dtype=torch.float32)
  fb = f(low)
  shape, dtype = fb.shape, fb.dtype
  b = torch.broadcast_to(low.to(fb.device, dtype), shape)
  a = torch.broadcast_to(
      torch.as_tensor(high, dtype=dtype, device=fb.device), shape
  )
  fa = f(a)
  c, fc = b, fb
  t = torch.full(shape, 0.5, dtype=dtype, device=fb.device)
  take = torch.abs(fa) < torch.abs(fb)
  best_x = torch.where(take, a, b)
  best_f = torch.where(take, fa, fb)
  converged = torch.zeros(shape, dtype=torch.bool, device=fb.device)
  finfo = torch.finfo(dtype)

  def safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)

  for _ in range(max_iterations):
    xt = a + t * (b - a)
    ft = f(xt)

    same = torch.sign(ft) == torch.sign(fa)
    a2, fa2 = xt, ft
    b2 = torch.where(same, b, a)
    fb2 = torch.where(same, fb, fa)
    c2 = torch.where(same, a, b)
    fc2 = torch.where(same, fa, fb)

    # Freeze converged lanes.
    a2 = torch.where(converged, a, a2)
    b2 = torch.where(converged, b, b2)
    c2 = torch.where(converged, c, c2)
    fa2 = torch.where(converged, fa, fa2)
    fb2 = torch.where(converged, fb, fb2)
    fc2 = torch.where(converged, fc, fc2)

    take = torch.abs(fa2) < torch.abs(fb2)
    xm = torch.where(take, a2, b2)
    fm = torch.where(take, fa2, fb2)
    improve = torch.abs(fm) < torch.abs(best_f)
    best_x = torch.where(improve, xm, best_x)
    best_f = torch.where(improve, fm, best_f)

    tol = 2.0 * finfo.eps * torch.abs(xm) + position_tolerance
    tlim = tol / torch.clamp(torch.abs(b2 - a2), min=finfo.tiny)
    converged = (
        converged | (torch.abs(best_f) <= value_tolerance) | (tlim > 0.5)
    )

    # Inverse quadratic interpolation when the iterate layout permits.
    xi = (a2 - b2) / torch.where(c2 == b2, torch.ones_like(c2), c2 - b2)
    phi = (fa2 - fb2) / torch.where(fc2 == fb2, torch.ones_like(fc2), fc2 - fb2)
    iqi_ok = (
        (torch.square(phi) < xi)
        & (torch.square(1.0 - phi) < 1.0 - xi)
        & (c2 != b2)
        & (fc2 != fb2)
        & (fb2 != fa2)
        & (fc2 != fa2)
    )
    t_iqi = (fa2 / safe(fb2 - fa2)) * (fc2 / safe(fb2 - fc2)) + (
        (c2 - a2) / safe(b2 - a2)
    ) * (fa2 / safe(fc2 - fa2)) * (fb2 / safe(fc2 - fb2))
    t = torch.where(iqi_ok, t_iqi, torch.full_like(t_iqi, 0.5))
    # Where tlim > 1 - tlim this returns 1 - tlim, as jnp.clip does.
    t = torch.clamp(t, min=tlim, max=1.0 - tlim)

    a, b, c, fa, fb, fc = a2, b2, c2, fa2, fb2, fc2
  return best_x


def normal_mixture_quantile_root(means, scales, q, axis=(0, 1), stats=None):
  """Exact quantile of a uniform mixture of Normals via root-finding.

  Args:
    means: (..., N) per-member means; `axis` indexes the ensemble dims.
    scales: broadcastable with `means` (callers add the trailing dim).
    q: scalar quantile in (0, 1).
    axis: ensemble axes to average the CDF over.
    stats: optional (min_mean, max_mean, max_scale) bracket statistics.

  Returns:
    (N,) tensor of mixture quantiles.
  """

  def f(x):
    return torch.mean(special.normal_cdf(x, means, scales), dim=axis) - q

  if stats is None:
    stats = (torch.amin(means), torch.amax(means), torch.amax(scales))
  min_mean, max_mean, max_scale = stats
  low = min_mean - 5.0 * max_scale
  high = max_mean + 5.0 * max_scale
  return find_root_chandrupatla(
      f, low, high, value_tolerance=1e-5, max_iterations=60
  )


def normal_mixture_quantile_approx(means, scales, q, axis=(0, 1)):
  """Moment-matched Normal approximation of the mixture quantile."""
  mixture_mean = means.mean(dim=axis)
  mixture_scale = torch.sqrt(
      (torch.square(scales) + torch.square(means)).mean(dim=axis)
      - torch.square(mixture_mean)
  )
  return special.normal_quantile(q, mixture_mean, mixture_scale)


def normal_mixture_quantiles(
    means, scales, quantiles, axis=(0, 1), approximate=False
):
  """A list of Normal-mixture quantiles (one (N,) tensor per q)."""
  fn = (
      normal_mixture_quantile_approx
      if approximate
      else normal_mixture_quantile_root
  )
  return [fn(means, scales[..., None], q, axis) for q in quantiles]


def count_mixture_quantile_root(dist, q, ensemble_axes=(0, 1), stats=None):
  """Quantile of an ensemble mixture of (zero-inflated) NB distributions.

  Args:
    dist: a `NegativeBinomial` or `ZeroInflatedNegativeBinomial` of
      `models/distributions.py` whose parameters carry the ensemble axes
      and a trailing row axis.
    q: scalar quantile in (0, 1).
    ensemble_axes: the axes the mixture averages over.
    stats: optional (max_mean, max_stddev) over all rows, so that chunks of
      one table's rows searched apart share one bracket.

  Returns:
    (N,) integer-valued float tensor of mixture quantiles.
  """
  q = torch.tensor(q, dtype=torch.float32)

  def f(x):
    return torch.mean(dist.cdf(x), dim=ensemble_axes) - q.to(x.device)

  if stats is None:
    stats = (torch.amax(dist.mean()), torch.amax(dist.stddev()))
  max_mean, max_std = stats
  high = max_mean + 1.1 * torch.rsqrt(1.0 - q).to(max_mean.device) * max_std
  root = find_root_chandrupatla(
      f, 0.0, high, value_tolerance=1e-5, max_iterations=60)
  prob_zero = torch.mean(dist.prob(0.0), dim=ensemble_axes)
  return torch.ceil(torch.where(prob_zero > q.to(root.device),
                                torch.zeros_like(root), root))
