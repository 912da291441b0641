"""The port's count-model special functions (`bayesnf_torch.ops.special`)
against `bayesnf_tpu.ops.special` and `jax.scipy.special`.

- The Stirling series that K1's count epilogue evaluates, over x in [1e-3,
  1e8]: rtol 1e-6, plus two float32 ulps of the sum of the magnitudes of
  the series' terms (the two packages' `log` round differently by an ulp,
  and near the zeros of log Gamma and digamma the terms cancel).
- `betainc` and `nb_cdf` (total_count 1e-3..1e6, x 0..1e4 integer and
  not, p in (0, 1)): atol 1e-5, the quantile search's value tolerance,
  wherever float32 determines the value to 1e-6. Elsewhere (a large total
  count near the bulk of its distribution) the log-gamma terms of the
  prefactor are ~1e6 and their rounding alone moves either package's
  result by up to ~0.2 from the exact one; there both must stay in [0, 1].
- The edge cases of XLA's lowering, and the continuity of `nb_cdf` in x.
- The Negative Binomial mean and variance: rtol 1e-5; its log-pmf: rtol
  1e-5 plus four ulps of its terms (lgamma(r + x) - lgamma(r) cancels).
"""

import jax.numpy as jnp
from jax.scipy import special as jsp_special
import numpy as np
import pytest
import scipy.special
import torch

from bayesnf_torch.ops import special as t_special
from bayesnf_tpu.ops import special as j_special

torch.set_num_threads(1)

EPS32 = 2.0 ** -23
CDF_ATOL = 1e-5


def _gammaln_terms(x):
  """Sum of the magnitudes of `gammaln_stirling`'s terms, in float64."""
  xs = np.minimum(x, 1e6)
  z = xs + 6.0
  shifted = (np.abs((z - 0.5) * np.log(z)) + z
             + sum(np.abs(np.log((xs + 2 * i) * (xs + 2 * i + 1)))
                   for i in range(3)))
  return np.where(x > 1e6, np.abs((x - 0.5) * np.log(x)) + x, shifted)


def _digamma_terms(x):
  return np.log(x + 6.0) + 1.0 / x + 6.0 / (x + 1.0)


@pytest.mark.parametrize('name,terms', [
    ('gammaln_stirling', _gammaln_terms),
    ('digamma_stirling', _digamma_terms),
])
def test_stirling_series_match_jax(name, terms):
  x = np.geomspace(1e-3, 1e8, 20001).astype(np.float32)
  x = np.concatenate([x, np.float32([1.0, 2.0, 1.4616321, 1e6, 1e6 + 64])])
  got = getattr(t_special, name)(torch.as_tensor(x)).numpy().astype(float)
  want = np.asarray(getattr(j_special, name)(jnp.asarray(x))).astype(float)
  bound = 1e-6 * np.abs(want) + 2 * EPS32 * terms(x.astype(float))
  assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _count_cdf_points(n, seed=0):
  """(total_count, x, p) over the ranges the count models reach."""
  rng = np.random.default_rng(seed)
  total_count = np.exp(rng.uniform(np.log(1e-3), np.log(1e6), n))
  x = np.where(rng.uniform(size=n) < 0.5, rng.integers(0, 10_001, n),
               np.exp(rng.uniform(np.log(1e-3), np.log(1e4), n)))
  p = rng.uniform(1e-6, 1 - 1e-6, n)
  return [a.astype(np.float32) for a in (total_count, x, p)]


def _determined(a, b, x):
  """Where float32 determines I_x(a, b) to 1e-6: the un-reflected value the
  continued fraction computes, times the magnitude of the log terms of its
  prefactor, times 2^-24, in float64."""
  a, b, x = (t.astype(float) for t in (a, b, x))
  exact = scipy.special.betainc(a, b, x)
  swap = x >= (a + 1) / (a + b + 2)
  a2, b2, x2 = np.where(swap, b, a), np.where(swap, a, b), np.where(
      swap, 1 - x, x)
  terms = (np.abs(a2 * np.log(x2)) + np.abs(b2 * np.log1p(-x2))
           + np.abs(scipy.special.gammaln(a2))
           + np.abs(scipy.special.gammaln(b2))
           + np.abs(scipy.special.gammaln(a2 + b2)))
  return np.where(swap, 1 - exact, exact) * terms * 2.0 ** -24 < 1e-6


def test_betainc_matches_jax():
  total_count, x, p = _count_cdf_points(20_000)
  got = t_special.betainc(torch.as_tensor(total_count),
                          torch.as_tensor(1 + x), torch.as_tensor(p)).numpy()
  want = np.asarray(jsp_special.betainc(total_count, 1 + x, p))
  ok = _determined(total_count, 1 + x, p)
  assert ok.mean() > 0.95
  # Every decade of total count is held somewhere.
  decades = np.floor(np.log10(total_count[ok])).astype(int)
  assert set(range(-3, 6)) <= set(decades.tolist())
  np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=CDF_ATOL)
  assert np.isfinite(got).all()
  assert ((got >= 0) & (got <= 1)).all()


@pytest.mark.parametrize('x', [0.0, 0.5, 1.0, 1.5, -0.5])
def test_betainc_edge_cases_match_jax(x):
  # (Not subnormal parameters: XLA on the CPU flushes them to zero.)
  a = np.float32([0, 1, 0, 2, -1, 2, np.nan, np.inf, 1, 1e-30, 3])
  b = np.float32([1, 0, 0, 2, 2, -1, 1, 1, np.inf, 2, 1e-30])
  xs = np.full_like(a, x)
  got = t_special.betainc(torch.as_tensor(a), torch.as_tensor(b),
                          torch.as_tensor(xs)).numpy()
  want = np.asarray(jsp_special.betainc(a, b, xs))
  np.testing.assert_allclose(got, want, rtol=0, atol=CDF_ATOL)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_nb_cdf_matches_jax_and_is_continuous():
  total_count, x, p = _count_cdf_points(20_000, seed=1)
  logits = (np.log1p(-p.astype(float)) - np.log(p)).astype(np.float32)
  got = t_special.nb_cdf(torch.as_tensor(x), torch.as_tensor(total_count),
                         torch.as_tensor(logits)).numpy()
  want = np.asarray(j_special.nb_cdf(x, total_count, logits))
  ok = _determined(total_count, 1 + x, p)
  np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=CDF_ATOL)
  # Negative x gives 0.
  assert t_special.nb_cdf(torch.tensor(-0.5), torch.tensor(3.0),
                          torch.tensor(0.2)).item() == 0.0
  # Continuous in x: between two integers the CDF rises strictly and
  # smoothly, where a floored step CDF would stay flat.
  grid = torch.linspace(0.0, 12.0, 241)
  cdf = t_special.nb_cdf(grid, torch.tensor(2.5), torch.tensor(0.7))
  steps = torch.diff(cdf)
  assert bool((steps > 0).all())
  assert steps.max().item() < 0.02


def test_nb_log_prob_mean_and_variance_match_jax():
  # The log-pmf to rtol 1e-5 plus four float32 ulps of the sum of its
  # terms' magnitudes: lgamma(r + x) - lgamma(r) cancels for large r, and
  # the packages' lgamma round differently by an ulp or two.
  rng = np.random.default_rng(2)
  total_count = np.exp(rng.uniform(-5, 8, 500)).astype(np.float32)
  logits = rng.normal(scale=3.0, size=500).astype(np.float32)
  x = rng.poisson(5.0, 500).astype(np.float32)
  args = [torch.as_tensor(a) for a in (x, total_count, logits)]
  got = t_special.nb_log_prob(*args).numpy().astype(float)
  want = np.asarray(j_special.nb_log_prob(x, total_count, logits)).astype(
      float)
  r, l, xd = (a.astype(float) for a in (total_count, logits, x))
  terms = (np.abs(scipy.special.gammaln(r + xd))
           + np.abs(scipy.special.gammaln(1 + xd))
           + np.abs(scipy.special.gammaln(r)) + np.abs(r * np.logaddexp(0, l))
           + np.abs(xd * np.logaddexp(0, -l)))
  assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 4 * EPS32 * terms).all()
  for name in ('nb_mean', 'nb_variance'):
    np.testing.assert_allclose(
        getattr(t_special, name)(*args[1:]).numpy(),
        np.asarray(getattr(j_special, name)(total_count, logits)),
        rtol=1e-5)
