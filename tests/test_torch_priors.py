"""`bayesnf_torch.models.priors.sample_prior` against the JAX package's.

The two packages draw their uniforms from different generators, so the
same u, made in numpy, goes through both inverse CDFs (the JAX one with
`jax.random.uniform` replaced by the numpy draws). The port's own draws are
held to the prior's moments: mean `prior_loc` and variance pi^2 / 3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import priors as t_priors
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import priors as j_priors

torch.set_num_threads(1)

CONFIG = dict(
    width=16, depth=2, input_scales=[49.0, 1.0, 1.0],
    fourier_degrees=[3, 2, 0], interactions=[(0, 1)],
    seasonality_periods=[24.0], num_seasonal_harmonics=[2],
)


def test_sample_prior_is_the_jax_inverse_cdf_of_the_same_uniforms(monkeypatch):
  j_config = j_field.FieldConfig.create(**CONFIG)
  specs = t_field.param_specs(t_field.FieldConfig.create(**CONFIG))
  rng = np.random.default_rng(0)
  # Inside [1e-6, 1 - 1e-6], and the edges themselves.
  us = [rng.uniform(1e-6, 1 - 1e-6, size=s.shape).astype(np.float32)
        for s in specs]
  us[-2].reshape(-1)[:2] = [1e-6, 1 - 1e-6]
  pending = list(us)

  def uniform(key, shape, minval, maxval, dtype):
    del key, minval, maxval
    u = pending.pop(0)
    assert u.shape == tuple(shape)
    return jnp.asarray(u, dtype=dtype)

  monkeypatch.setattr(jax.random, 'uniform', uniform)
  want = j_priors.sample_prior(j_config, jax.random.PRNGKey(0))
  assert not pending
  assert len(want) == len(specs)
  for spec, u, w in zip(specs, us, want):
    got = t_priors.logistic_quantile(torch.from_numpy(u), spec.prior_loc)
    np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-6, err_msg=spec.name)


def test_logistic_quantile_clips_u():
  got = t_priors.logistic_quantile(torch.tensor([0.0, 1.0]), 0.0)
  edges = t_priors.logistic_quantile(torch.tensor([1e-6, 1 - 1e-6]), 0.0)
  assert torch.equal(got, edges) and bool(torch.isfinite(got).all())
  # log(1e-6 / (1 - 1e-6)); the upper edge is 1 - 1e-6 rounded to float32.
  np.testing.assert_allclose(got[0].item(), -13.8155, rtol=1e-5)


def test_sample_prior_shapes_device_and_seed():
  config = t_field.FieldConfig.create(**CONFIG)
  draw = lambda seed: t_priors.sample_prior(
      config, torch.Generator().manual_seed(seed))
  a, b, c = draw(1), draw(1), draw(2)
  for spec, x, y, z in zip(t_field.param_specs(config), a, b, c):
    assert tuple(x.shape) == spec.shape and x.dtype == torch.float32
    assert x.device == torch.device('cpu')
    assert torch.equal(x, y)
  assert not torch.equal(a[7], c[7])


@pytest.mark.parametrize('loc_name', ['log_noise_scale', 'nb_shape_raw'])
def test_sample_prior_moments(loc_name):
  """Mean `prior_loc` and variance pi^2 / 3, within 4 standard errors."""
  config = t_field.FieldConfig.create(**CONFIG)
  specs = t_field.param_specs(config)
  generator = torch.Generator().manual_seed(3)
  if loc_name == 'nb_shape_raw':  # A scalar leaf: many members.
    index = [s.name for s in specs].index(loc_name)
    x = torch.stack([t_priors.sample_prior(config, generator)[index]
                     for _ in range(4000)]).double()
  else:  # Every loc-0 entry of a few members, pooled.
    x = torch.cat([
        torch.cat([p.reshape(-1) for s, p in zip(specs, draw)
                   if s.prior_loc == 0.0])
        for draw in (t_priors.sample_prior(config, generator)
                     for _ in range(60))]).double()
  loc = {s.name: s.prior_loc for s in specs}[loc_name]
  var = math.pi ** 2 / 3
  n = x.numel()
  assert abs(x.mean().item() - loc) < 4 * math.sqrt(var / n), (n, x.mean())
  # Var of the sample variance: var^2 (2 / (n - 1) + 1.2 / n), the
  # logistic's excess kurtosis being 1.2.
  se_var = var * math.sqrt(2 / (n - 1) + 1.2 / n)
  assert abs(x.var().item() - var) < 4 * se_var, (n, x.var())
