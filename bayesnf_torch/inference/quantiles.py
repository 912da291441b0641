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
- The mixture CDF's mean over the members (`member_mean`) takes one order
  of sums whatever the number of rows, so a chunk of rows searched alone
  gives the whole table's bits (`inference/predict_stream.py`).
- NORMAL, exact, on the 'kernel' backend: the same search in one launch of
  `ops/mixture_quantile.py`'s kernel for up to 32 quantiles of every row,
  each row stopping when it converges (`normal_mixture_quantiles_kernel`).
- While a profiler records, each search is a `bnf.predict.quantile` span
  and counts its iterations (`ITERATIONS_RUN`) and those it needed
  (`ITERATIONS_NEEDED`: until every lane had converged; the rest leave the
  roots as they are), on the device, for `utils/profiling.counters`. The
  kernel's launch is one span for all its quantiles; for each quantile it
  counts the most iterations a row ran, under both names, so their ratio
  reads 1 there by construction (a row runs no iteration it does not
  need), and `KERNEL_SEARCHES` counts its quantiles. `member_mean` counts
  the blocks it sums (`MEMBER_BLOCKS`).
"""

import math

import torch

from bayesnf_torch.ops import mixture_quantile
from bayesnf_torch.ops import special
from bayesnf_torch.utils import profiling


# The members a sum over the ensemble axes takes in one piece. On CUDA, a
# mean over the leading axis of a (K, W) array, W a multiple of 128, takes
# one order of sums whatever W for K up to 1,020; past that torch's
# reduction splits the members over thread blocks by W (on an H100 over
# 1,920 members a 4,096-wide mean differed from a 38,144-wide one in 1,161
# columns, `chip_smoke.py` phase 16 (d)), while sums of blocks of 1,020
# members, added in order, agree at every width.
MEMBER_BLOCK = 1020

MEMBER_BLOCKS = 'bnf.predict.member_blocks'
ITERATIONS_RUN = 'bnf.rootfind.iterations_run'
ITERATIONS_NEEDED = 'bnf.rootfind.iterations_needed'
KERNEL_SEARCHES = 'bnf.rootfind.kernel_searches'


def member_mean(x, axis):
  """The mean of `x` over its leading ensemble `axis` (0, ..., d - 1), in
  an order of sums that does not depend on the trailing width: up to
  MEMBER_BLOCK members `torch.mean`, past it the sums of blocks of
  MEMBER_BLOCK members, added in block order, over the member count.

  Raises:
    ValueError: if `axis` is not the leading axes.
  """
  axis = tuple(axis)
  if axis != tuple(range(len(axis))):
    raise ValueError(f'{axis=} must be the leading axes.')
  k = math.prod(x.shape[:len(axis)])
  if profiling.recording():
    profiling.count(MEMBER_BLOCKS, -(-k // MEMBER_BLOCK))
  if k <= MEMBER_BLOCK:
    return torch.mean(x, dim=axis)
  flat = x.reshape((k,) + tuple(x.shape[len(axis):]))
  total = flat[:MEMBER_BLOCK].sum(dim=0)
  for lo in range(MEMBER_BLOCK, k, MEMBER_BLOCK):
    total = total + flat[lo:lo + MEMBER_BLOCK].sum(dim=0)
  return total / k


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

  counting = profiling.recording()
  settled = []  # Whether every lane had converged as each iteration began.
  for _ in range(max_iterations):
    if counting:
      settled.append(converged.all())
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
  if counting:
    profiling.count(ITERATIONS_RUN, max_iterations)
    profiling.count(ITERATIONS_NEEDED,
                    (~torch.stack(settled)).sum() if settled else 0)
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
    return member_mean(special.normal_cdf(x, means, scales), axis) - q

  with profiling.span('bnf.predict.quantile'):
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
    means, scales, quantiles, axis=(0, 1), approximate=False, stats=None
):
  """A list of Normal-mixture quantiles (one (N,) tensor per q).

  Args:
    means: (..., N) per-member means; `axis` indexes the ensemble dims.
    scales: per-member scales, the shape of `means` without its row axis.
    quantiles: sequence of quantiles in (0, 1).
    axis: ensemble axes to average over.
    approximate: the moment-matched Normal instead of root-finding.
    stats: optional (min_mean, max_mean) over all rows, so that chunks of
      one table's rows searched apart share one bracket (root-finding
      only).
  """
  scales = scales[..., None]
  if approximate:
    return [normal_mixture_quantile_approx(means, scales, q, axis)
            for q in quantiles]
  if stats is not None:
    stats = (*stats, torch.amax(scales))
  return [normal_mixture_quantile_root(means, scales, q, axis, stats=stats)
          for q in quantiles]


def normal_mixture_quantiles_kernel(means, scales, quantiles, stats):
  """`normal_mixture_quantiles` over one member axis, by the search kernel
  (`ops/mixture_quantile.py`): up to 32 quantiles a launch, each row
  stopping when it converges.

  Args:
    means: (K, N) float32 CUDA member means, rows contiguous.
    scales: (K,) member scales.
    quantiles: sequence of quantiles in (0, 1).
    stats: (min_mean, max_mean) over all rows, as for
      `normal_mixture_quantiles`.

  Returns:
    (num quantiles, N) tensor of mixture quantiles.
  """
  with profiling.span('bnf.predict.quantile'):
    stats = (*stats, torch.amax(scales))
    counting = profiling.recording()
    most = (torch.zeros(len(quantiles), dtype=torch.int32,
                        device=means.device) if counting else None)
    roots = mixture_quantile.mixture_quantiles(means, scales, quantiles,
                                               stats, most)
    if counting:
      ran = most.sum()
      profiling.count(ITERATIONS_RUN, ran)
      profiling.count(ITERATIONS_NEEDED, ran)
      profiling.count(KERNEL_SEARCHES, len(quantiles))
    return roots


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
    return member_mean(dist.cdf(x), ensemble_axes) - q.to(x.device)

  with profiling.span('bnf.predict.quantile'):
    if stats is None:
      stats = (torch.amax(dist.mean()), torch.amax(dist.stddev()))
    max_mean, max_std = stats
    high = (max_mean
            + 1.1 * torch.rsqrt(1.0 - q).to(max_mean.device) * max_std)
    root = find_root_chandrupatla(
        f, 0.0, high, value_tolerance=1e-5, max_iterations=60)
    prob_zero = member_mean(dist.prob(0.0), ensemble_axes)
    return torch.ceil(torch.where(prob_zero > q.to(root.device),
                                  torch.zeros_like(root), root))
