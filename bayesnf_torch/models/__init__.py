"""Model layer: field configuration, feature encoders, likelihoods, priors.

Exports the names the JAX package's `bayesnf_tpu.models` exports.
"""

from bayesnf_torch.models.field import FieldConfig
from bayesnf_torch.models.field import apply_field
from bayesnf_torch.models.field import init_params
from bayesnf_torch.models.field import param_specs
from bayesnf_torch.models.likelihoods import LikelihoodDist

__all__ = [
    'FieldConfig',
    'apply_field',
    'init_params',
    'param_specs',
    'LikelihoodDist',
]
