"""Prior over field parameters (counterpart of `bayesnf_tpu/models/priors.py`).

Every parameter entry has an elementwise Logistic(loc, 1) density: loc 0
everywhere except the NB shape parameter (loc -1.5), as `param_specs` lists.
`sample_prior` draws one member from it by the logistic inverse CDF.
"""

import torch

from bayesnf_torch.models import field as field_lib
from bayesnf_torch.ops import special


def prior_log_prob(config: field_lib.FieldConfig, params: tuple) -> torch.Tensor:
  """Total prior log-density of each member's params.

  Args:
    config: model config.
    params: flat parameter tuple, each leaf with one leading member axis E.

  Returns:
    (E,) log-densities, summed leaf by leaf in `param_specs` order.
  """
  specs = field_lib.param_specs(config)
  e = params[0].shape[0]
  total = torch.zeros((e,), dtype=torch.float32, device=params[0].device)
  for spec, p in zip(specs, params):
    lp = special.logistic_log_prob(p, loc=spec.prior_loc)
    total = total + lp.reshape(e, -1).sum(dim=1)
  return total


def logistic_quantile(u: torch.Tensor, loc: float) -> torch.Tensor:
  """Logistic(loc, 1)'s inverse CDF at `u`, clipped to [1e-6, 1 - 1e-6]."""
  u = u.clamp(1e-6, 1.0 - 1e-6)
  return loc + torch.log(u) - torch.log1p(-u)


def sample_prior(config: field_lib.FieldConfig,
                 generator: torch.Generator) -> tuple:
  """One member's params drawn from the prior, leaf by leaf in
  `param_specs` order, by the logistic inverse CDF of uniforms from
  `generator`, on its device. (The JAX package draws the uniforms from a
  split key, so the same seed gives other values there.)"""
  return tuple(
      logistic_quantile(
          torch.rand(spec.shape, generator=generator,
                     device=generator.device, dtype=torch.float32),
          spec.prior_loc)
      for spec in field_lib.param_specs(config))
