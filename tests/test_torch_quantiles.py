"""The port's Normal-mixture quantiles against `bayesnf_tpu`'s.

`torch.special.ndtr` and `jax.scipy.special.ndtr` round differently, so the
two Chandrupatla searches may stop at different points that both meet the
1e-5 value tolerance. The tests therefore hold the port's root to the
mixture CDF (scipy, float64) and the two roots to each other within
1e-4 of the largest member scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats
import torch

from bayesnf_torch.inference import quantiles as t_quantiles
from bayesnf_tpu.inference import quantiles as j_quantiles

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
