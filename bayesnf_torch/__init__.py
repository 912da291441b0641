"""BayesNF in PyTorch, with hand-written CUDA kernels for Hopper.

The serving and training paths of `bayesnf_tpu` (MAP, MLE and VI fits, full
batch or minibatch; load -> predict; NORMAL) ported to PyTorch. It reads and
writes the same estimator artifacts. `metrics` scores a fit, and
`python -m bayesnf_torch.cli.evaluate` runs the paper's experiment command.
"""

__version__ = '0.1.0'

from bayesnf_torch import metrics
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldEstimator
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMAP
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMLE
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldVI

__all__ = [
    'BayesianNeuralFieldEstimator',
    'BayesianNeuralFieldMAP',
    'BayesianNeuralFieldMLE',
    'BayesianNeuralFieldVI',
    'metrics',
    '__version__',
]
