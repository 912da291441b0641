"""The port's ensemble-mixture quantiles against `bayesnf_tpu`'s.

`torch.special.ndtr` and `jax.scipy.special.ndtr` round differently, so the
two Chandrupatla searches may stop at different points that both meet the
1e-5 value tolerance. The tests therefore hold the port's root to the
mixture CDF (scipy, float64) and the two roots to each other within
1e-4 of the largest member scale.

The count-mixture quantiles (NB, ZINB) are integers after the ceiling: the
port's must equal the JAX package's except on at most max(1, 1%) of the
rows, and there by one count (PARITY.md), since a root a hair from an
integer may ceil either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats
import torch

from bayesnf_torch.inference import quantiles as t_quantiles
from bayesnf_torch.models import distributions as t_dist
from bayesnf_tpu.inference import quantiles as j_quantiles
from bayesnf_tpu.models import distributions as j_dist

torch.set_num_threads(1)

QS = (0.025, 0.5, 0.975)


def _mixture(ens_shape, n, seed):
  rng = np.random.default_rng(seed)
  means = rng.normal(scale=3.0, size=ens_shape + (n,)).astype(np.float32)
  scales = rng.uniform(0.2, 2.0, size=ens_shape).astype(np.float32)
  return means, scales


def _mixture_cdf(x, means, scales, axis):
  cdf = stats.norm.cdf(
      np.float64(x), np.float64(means), np.float64(scales)[..., None])
  return cdf.mean(axis=axis)


@pytest.mark.parametrize('ens_shape', [(1, 4), (2, 3)])
def test_root_matches_jax_and_the_mixture_cdf(ens_shape):
  means, scales = _mixture(ens_shape, 50, seed=sum(ens_shape))
  got = t_quantiles.normal_mixture_quantiles(
      torch.from_numpy(means), torch.from_numpy(scales), QS)
  want = j_quantiles.normal_mixture_quantiles(
      jnp.asarray(means), jnp.asarray(scales), QS)
  for q, g, w in zip(QS, got, want):
    assert g.shape == (50,)
    residual = _mixture_cdf(g.numpy(), means, scales, (0, 1)) - q
    assert np.abs(residual).max() <= 2e-5
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                               atol=1e-4 * scales.max())


def test_approx_matches_jax():
  means, scales = _mixture((2, 3), 40, seed=7)
  got = t_quantiles.normal_mixture_quantiles(
      torch.from_numpy(means), torch.from_numpy(scales), QS,
      approximate=True)
  want = j_quantiles.normal_mixture_quantiles(
      jnp.asarray(means), jnp.asarray(scales), QS, approximate=True)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                               atol=2e-5)


def test_root_with_given_bracket_stats():
  means, scales = _mixture((1, 3), 20, seed=3)
  m, s = torch.from_numpy(means), torch.from_numpy(scales)[..., None]
  stats_ = (m.amin() - 1.0, m.amax() + 1.0, s.amax())
  got = t_quantiles.normal_mixture_quantile_root(m, s, 0.9, stats=stats_)
  residual = _mixture_cdf(got.numpy(), means, scales, (0, 1)) - 0.9
  assert np.abs(residual).max() <= 2e-5


def test_find_root_matches_jax_on_a_cubic():
  shifts = np.linspace(-2.0, 3.0, 11).astype(np.float32)
  got = t_quantiles.find_root_chandrupatla(
      lambda x: x ** 3 - torch.from_numpy(shifts), -5.0, 5.0)
  want = j_quantiles.find_root_chandrupatla(
      lambda x: x ** 3 - jnp.asarray(shifts), -5.0, 5.0)
  np.testing.assert_allclose(got.numpy(), np.cbrt(shifts), atol=1e-4)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_clamp_with_min_above_max_returns_max_like_jnp_clip():
  # The search clamps t to [tlim, 1 - tlim]; once tlim > 0.5 the bounds
  # cross, and both packages must then return 1 - tlim.
  t = np.array([0.1, 0.5, 0.9], np.float32)
  tlim = np.array([0.7, 0.6, 0.8], np.float32)
  got = torch.clamp(torch.from_numpy(t), min=torch.from_numpy(tlim),
                    max=torch.from_numpy(1.0 - tlim))
  want = jnp.clip(jnp.asarray(t), jnp.asarray(tlim), jnp.asarray(1.0 - tlim))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(got.numpy(), 1.0 - tlim)


def _count_params(ens_shape, n, seed, zero_inflated):
  """Forecast parameters (total_count, logits[, pi]) of a count ensemble
  like a fitted one: total counts from 1 to 30 (the prior's shape loc -1.5
  gives ~5), means from ~0.1 to ~50."""
  rng = np.random.default_rng(seed)
  total_count = np.exp(rng.uniform(0, 3.4, ens_shape)).astype(np.float32)
  mean = np.exp(rng.uniform(-2, 3.9, ens_shape + (n,)))
  logits = (np.log(mean) - np.log(total_count[..., None])).astype(np.float32)
  params = [total_count, logits]
  if zero_inflated:
    params.append(np.broadcast_to(
        rng.uniform(0.0, 0.6, ens_shape + (1,)), logits.shape).astype(
            np.float32))
  return params


def _mixture_count_cdf(k, params):
  """The mixture's CDF at integers k (N,), exactly (scipy, float64)."""
  total_count, logits = (p.astype(float) for p in params[:2])
  r = total_count[..., None]
  p_success = 1.0 / (1.0 + np.exp(logits))  # sigmoid(-logits)
  cdf = stats.nbinom.cdf(k, r, p_success)
  if len(params) == 3:
    pi = params[2].astype(float)
    cdf = pi * (k >= 0) + (1.0 - pi) * cdf
  return cdf.reshape((-1, cdf.shape[-1])).mean(axis=0)


def _assert_counts_close(got, want):
  got, want = got.numpy(), np.asarray(want)
  assert np.array_equal(got, np.round(got)) and (got >= 0).all()
  off = np.abs(got - want)
  assert off.max() <= 1.0, off.max()
  assert (off > 0).sum() <= max(1, got.size // 100), (off > 0).sum()


@pytest.mark.parametrize('ens_shape', [(1, 4), (2, 3)])
@pytest.mark.parametrize('zero_inflated', [False, True], ids=['NB', 'ZINB'])
def test_count_root_matches_jax(zero_inflated, ens_shape):
  params = _count_params(ens_shape, 200, sum(ens_shape), zero_inflated)
  t_obs = t_dist.count_obs_dist(*[torch.from_numpy(p) for p in params])
  j_obs = j_dist.count_obs_dist(*[jnp.asarray(p) for p in params])
  for q in (0.05, 0.5, 0.9, 0.99):
    got = t_quantiles.count_mixture_quantile_root(t_obs, q)
    assert got.shape == (200,)
    _assert_counts_close(got, j_quantiles.count_mixture_quantile_root(
        j_obs, q, ensemble_axes=(0, 1)))
    # The least count whose mixture CDF reaches q, up to the search's
    # 1e-5 value tolerance.
    k = got.numpy().astype(float)
    assert (_mixture_count_cdf(k, params) >= q - 1e-5).all()
    assert (_mixture_count_cdf(k - 1, params) < q + 1e-5).all()


def test_count_root_clamps_to_zero_and_takes_given_stats():
  # Where the mixture's P(0) exceeds q the quantile is 0; given bracket
  # statistics (as a streamed predict passes them) give the same roots.
  params = _count_params((1, 3), 60, 5, zero_inflated=True)
  params[2][:, 0] = 0.95
  t_obs = t_dist.count_obs_dist(*[torch.from_numpy(p) for p in params])
  got = t_quantiles.count_mixture_quantile_root(t_obs, 0.3)
  assert got[0].item() == 0.0
  stats_ = (t_obs.mean().amax(), t_obs.stddev().amax())
  again = t_quantiles.count_mixture_quantile_root(t_obs, 0.3, stats=stats_)
  assert torch.equal(got, again)
  j_obs = j_dist.count_obs_dist(*[jnp.asarray(p) for p in params])
  _assert_counts_close(got, j_quantiles.count_mixture_quantile_root(
      j_obs, 0.3, ensemble_axes=(0, 1)))
