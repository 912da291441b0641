"""The port's distribution objects (`bayesnf_torch.models.distributions`)
against `bayesnf_tpu.models.distributions`.

Moments to rtol 2e-5 / atol 1e-5, elementwise log-probs and probs to
rtol 2e-5 / atol 1e-4 (an ulp of their log-gamma terms), CDFs to the
quantile search's 1e-5, on the same parameters, through `count_obs_dist`
and `Independent` as predict and `likelihood_model` build them. Draws come
from another generator than the JAX package's, so `sample` is held to its
moments only: the mean and variance of 40,000 draws per batch element
within five standard errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.models import distributions as t_dist
from bayesnf_tpu.models import distributions as j_dist

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=1e-5)


def _params(model, seed=0):
  """Forecast parameters of a (2, 3)-member ensemble over 25 rows."""
  rng = np.random.default_rng(seed)
  if model == 'NORMAL':
    return [rng.normal(size=(2, 3, 25)).astype(np.float32),
            rng.uniform(0.2, 2.0, (2, 3, 1)).astype(np.float32)]
  params = [np.exp(rng.uniform(0, 3, (2, 3))).astype(np.float32),
            rng.normal(scale=1.5, size=(2, 3, 25)).astype(np.float32)]
  if model == 'ZINB':
    params.append(np.broadcast_to(rng.uniform(0.05, 0.6, (2, 3, 1)),
                                  (2, 3, 25)).astype(np.float32))
  return params


def _build(lib, model, params, convert):
  params = [convert(p) for p in params]
  if model == 'NORMAL':
    base = lib.Normal(*params)
  else:
    base = lib.count_obs_dist(*params)
  return lib.Independent(base, 1)


@pytest.mark.parametrize('model', ['NORMAL', 'NB', 'ZINB'])
def test_moments_densities_and_cdfs_match_jax(model):
  params = _params(model)
  got = _build(t_dist, model, params, torch.from_numpy)
  want = _build(j_dist, model, params, jnp.asarray)
  rng = np.random.default_rng(1)
  x = (rng.normal(size=25) if model == 'NORMAL' else
       rng.poisson(4.0, 25)).astype(np.float32)
  x[:3] = 0.0
  for name in ('mean', 'stddev', 'variance'):
    np.testing.assert_allclose(getattr(got, name)().numpy(),
                               np.asarray(getattr(want, name)()), **TOL,
                               err_msg=name)
  xt = torch.from_numpy(x)
  for name in ('log_prob', 'prob'):
    np.testing.assert_allclose(getattr(got.distribution, name)(xt).numpy(),
                               np.asarray(getattr(want.distribution, name)(x)),
                               rtol=2e-5, atol=1e-4, err_msg=name)
  np.testing.assert_allclose(got.log_prob(xt).numpy(),
                             np.asarray(want.log_prob(x)), rtol=2e-5)
  np.testing.assert_allclose(got.prob(xt).numpy(), np.asarray(want.prob(x)),
                             rtol=1e-4, atol=1e-30)
  np.testing.assert_allclose(got.distribution.cdf(xt).numpy(),
                             np.asarray(want.distribution.cdf(x)), rtol=0,
                             atol=1e-5)
  np.testing.assert_allclose(got.cdf(xt).numpy(), np.asarray(want.cdf(x)),
                             rtol=1e-4, atol=1e-12)
  if model == 'NORMAL':
    np.testing.assert_allclose(
        got.distribution.quantile(0.9).numpy(),
        np.asarray(want.distribution.quantile(0.9)), **TOL)


@pytest.mark.parametrize('model', ['NORMAL', 'NB', 'ZINB'])
def test_sample_moments(model):
  params = _params(model, seed=2)
  params = [p[:1, :2, :4] if p.ndim == 3 else p[:1, :2] for p in params]
  dist = _build(t_dist, model, params, torch.from_numpy)
  draws = dist.sample(torch.Generator().manual_seed(3), (40_000,))
  assert draws.shape == (40_000, 1, 2, 4)
  if model != 'NORMAL':
    assert torch.equal(draws, torch.round(draws)) and bool((draws >= 0).all())
  mean = dist.mean().double()
  var = dist.variance().double()
  stderr = torch.sqrt(var / draws.shape[0])
  assert bool(((draws.double().mean(0) - mean).abs() <= 5 * stderr).all())
  # The sample variance's standard error, from the fourth moment.
  centred = draws.double() - mean
  var_stderr = torch.sqrt(((centred ** 2 - var) ** 2).mean(0)
                          / draws.shape[0])
  assert bool(((centred.pow(2).mean(0) - var).abs()
               <= 5 * var_stderr).all())


def test_zinb_sample_widens_before_drawing():
  # One pi per row and a scalar NB: every row gets a draw of its own.
  dist = t_dist.ZeroInflatedNegativeBinomial(
      torch.tensor(5.0), torch.tensor(1.0), torch.full((50,), 0.1))
  draws = dist.sample(torch.Generator().manual_seed(0), (3,))
  assert draws.shape == (3, 50)
  assert len(set(draws[0].tolist())) > 3
