"""Evaluation metrics for probabilistic spatiotemporal forecasts
(counterpart of `bayesnf_tpu/metrics.py`).

- point metrics on a flattened prediction (`rmse`, `mae`);
- interval metrics on predicted quantiles (`coverage`, `interval_width`);
- `crps_ensemble` on posterior-predictive draws, e.g.
  `model.likelihood_model(df).sample(generator, (k,))` flattened over the
  ensemble axes, plus the closed-form `crps_normal` oracle.

Each takes numpy arrays or tensors, computes in float32 as the JAX package
does, and returns a 0-d float32 tensor on the device of its first tensor
argument (the CPU for numpy inputs).
"""

import math

import numpy as np
import torch


def _tensors(*xs):
  """`xs` as float32 tensors on the device of the first tensor among them."""
  device = next((x.device for x in xs if isinstance(x, torch.Tensor)), 'cpu')
  return tuple(
      torch.as_tensor(x if isinstance(x, torch.Tensor)
                      else np.array(x, dtype=np.float32),  # A writable copy.
                      dtype=torch.float32, device=device)
      for x in xs)


def rmse(y, yhat):
  """Root mean squared error."""
  y, yhat = _tensors(y, yhat)
  return torch.sqrt(torch.mean((yhat - y) ** 2))


def mae(y, yhat):
  """Mean absolute error."""
  y, yhat = _tensors(y, yhat)
  return torch.mean(torch.abs(yhat - y))


def coverage(y, lower, upper):
  """Fraction of observations inside [lower, upper]."""
  y, lower, upper = _tensors(y, lower, upper)
  return torch.mean(((y >= lower) & (y <= upper)).float())


def interval_width(lower, upper):
  """Mean predictive-interval width."""
  lower, upper = _tensors(lower, upper)
  return torch.mean(upper - lower)


def crps_ensemble(y, samples, fair=True):
  """Mean CRPS of an empirical (ensemble) predictive distribution.

  CRPS(F, y) = E|X - y| - 0.5 E|X - X'| with X, X' ~ F, estimated from
  `samples`. With `fair=True` the spread term uses the M(M-1) denominator
  (the "fair" estimator, unbiased for the underlying distribution's CRPS);
  otherwise the classical M^2 form (the empirical distribution's exact
  CRPS).

  Args:
    y: (N,) observations.
    samples: (M, N) predictive draws; flatten any leading ensemble or draw
      axes into M first (`samples.reshape(-1, n)`).
    fair: estimator variant (see above).

  Returns:
    0-d mean CRPS over the N observations.

  Raises:
    ValueError: if `fair` and M < 2.
  """
  y, samples = _tensors(y, samples)
  m = samples.shape[0]
  if fair and m < 2:
    raise ValueError(
        'crps_ensemble(fair=True) needs at least 2 samples (the M(M-1) '
        f'spread term is undefined at M={m}); pass fair=False for the '
        'single-sample empirical form.'
    )
  term_y = torch.mean(torch.abs(samples - y[None, :]), dim=0)
  # Pairwise spread via the sorted-sample identity:
  #   sum_{i,j} |x_i - x_j| = 2 * sum_k (2k + 1 - M) x_(k),  k = 0..M-1
  # O(M log M) instead of the O(M^2) double loop.
  sorted_s = torch.sort(samples, dim=0).values
  weights = 2.0 * torch.arange(1, m + 1, dtype=torch.float32,
                               device=samples.device) - m - 1.0
  pair_sum = 2.0 * torch.sum(weights[:, None] * sorted_s, dim=0)
  denom = m * (m - 1) if fair else m * m
  term_spread = pair_sum / (2.0 * denom)
  return torch.mean(term_y - term_spread)


def crps_normal(y, loc, scale):
  """Closed-form mean CRPS of Normal(loc, scale) forecasts.

  CRPS = scale * (z * (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi)),
  z = (y - loc)/scale.
  """
  y, loc, scale = _tensors(y, loc, scale)
  z = (y - loc) / scale
  phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
  big_phi = torch.special.ndtr(z)
  return torch.mean(
      scale * (z * (2.0 * big_phi - 1.0) + 2.0 * phi - 1.0 / math.sqrt(math.pi))
  )
