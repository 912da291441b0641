"""Prior over field parameters (counterpart of `bayesnf_tpu/models/priors.py`).

Every parameter entry has an elementwise Logistic(loc, 1) density: loc 0
everywhere except the NB shape parameter (loc -1.5), as `param_specs` lists.
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
