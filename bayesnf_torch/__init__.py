"""BayesNF in PyTorch, with hand-written CUDA kernels for Hopper.

The serving and training paths of `bayesnf_tpu` (MAP, MLE and VI fits, full
batch or minibatch; load -> predict; NORMAL) ported to PyTorch. It reads and
writes the same estimator artifacts.
"""

from bayesnf_torch.spatiotemporal import BayesianNeuralFieldEstimator
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMAP
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldMLE
from bayesnf_torch.spatiotemporal import BayesianNeuralFieldVI

__all__ = [
    'BayesianNeuralFieldEstimator',
    'BayesianNeuralFieldMAP',
    'BayesianNeuralFieldMLE',
    'BayesianNeuralFieldVI',
]
