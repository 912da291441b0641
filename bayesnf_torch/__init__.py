"""BayesNF in PyTorch, with hand-written CUDA kernels for Hopper.

The serving path of `bayesnf_tpu` (load -> predict, NORMAL) ported to
PyTorch. It reads and writes the same estimator artifacts.
"""

from bayesnf_torch.spatiotemporal import BayesianNeuralFieldEstimator
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMAP
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMLE

__all__ = [
    'BayesianNeuralFieldEstimator',
    'BayesianNeuralFieldMAP',
    'BayesianNeuralFieldMLE',
]
