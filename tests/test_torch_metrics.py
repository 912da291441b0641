"""The port's metrics (`bayesnf_torch/metrics.py`) against the JAX package's
(`bayesnf_tpu/metrics.py`) on the same seeded numpy inputs, to rtol 1e-6.

Both compute in float32; the sums run in other orders, which costs a few
ulps. Also: the inputs may be tensors, and the result is a 0-d float32
tensor on their device.
"""

import numpy as np
import pytest
import torch

from bayesnf_torch import metrics as port_metrics
from bayesnf_tpu import metrics as jax_metrics

torch.set_num_threads(1)

RTOL = 1e-6
N = 257


def _inputs(seed, m=8):
  rng = np.random.default_rng(seed)
  y = rng.normal(3.0, 2.0, size=N)
  loc = y + rng.normal(0.0, 1.0, size=N)
  scale = rng.uniform(0.5, 2.0, size=N)
  samples = loc + scale * rng.normal(size=(m, N))
  lower, upper = loc - 1.96 * scale, loc + 1.96 * scale
  return y, loc, scale, samples, lower, upper


def _check(port, jax_value):
  assert isinstance(port, torch.Tensor)
  assert port.ndim == 0 and port.dtype == torch.float32
  np.testing.assert_allclose(float(port), float(jax_value), rtol=RTOL)


@pytest.mark.parametrize('name', ['rmse', 'mae'])
def test_point_metrics_match_jax(name):
  y, loc, *_ = _inputs(0)
  _check(getattr(port_metrics, name)(y, loc),
         getattr(jax_metrics, name)(y, loc))


def test_interval_metrics_match_jax():
  y, _, _, _, lower, upper = _inputs(1)
  _check(port_metrics.coverage(y, lower, upper),
         jax_metrics.coverage(y, lower, upper))
  _check(port_metrics.interval_width(lower, upper),
         jax_metrics.interval_width(lower, upper))


@pytest.mark.parametrize('m', [2, 8, 64])
@pytest.mark.parametrize('fair', [True, False], ids=['fair', 'unfair'])
def test_crps_ensemble_matches_jax(m, fair):
  y, _, _, samples, _, _ = _inputs(2 + m, m=m)
  _check(port_metrics.crps_ensemble(y, samples, fair=fair),
         jax_metrics.crps_ensemble(y, samples, fair=fair))


def test_crps_ensemble_is_the_pairwise_definition():
  """The sorted-sample identity equals the O(M^2) double sum."""
  y, _, _, samples, _, _ = _inputs(3, m=16)
  m = samples.shape[0]
  pairs = np.abs(samples[:, None, :] - samples[None, :, :]).sum(axis=(0, 1))
  want = np.mean(np.abs(samples - y).mean(axis=0) - pairs / (2 * m * (m - 1)))
  np.testing.assert_allclose(
      float(port_metrics.crps_ensemble(y, samples)), want, rtol=1e-5)


def test_crps_ensemble_fair_needs_two_samples():
  y, _, _, samples, _, _ = _inputs(4, m=1)
  with pytest.raises(ValueError, match='at least 2 samples'):
    port_metrics.crps_ensemble(y, samples, fair=True)
  with pytest.raises(ValueError, match='at least 2 samples'):
    jax_metrics.crps_ensemble(y, samples, fair=True)
  _check(port_metrics.crps_ensemble(y, samples, fair=False),
         jax_metrics.crps_ensemble(y, samples, fair=False))


def test_crps_normal_matches_jax_and_the_large_ensemble():
  y, loc, scale, *_ = _inputs(5)
  _check(port_metrics.crps_normal(y, loc, scale),
         jax_metrics.crps_normal(y, loc, scale))
  # The closed form is the limit of the fair ensemble estimator.
  rng = np.random.default_rng(6)
  draws = loc + scale * rng.normal(size=(4096, N))
  np.testing.assert_allclose(
      float(port_metrics.crps_ensemble(y, draws)),
      float(port_metrics.crps_normal(y, loc, scale)), rtol=2e-2)


def test_tensor_inputs_keep_their_device_and_values():
  y, loc, scale, samples, _, _ = _inputs(7)
  as_t = lambda a: torch.tensor(a, dtype=torch.float64)
  got = port_metrics.crps_ensemble(as_t(y), as_t(samples))
  assert got.device == torch.device('cpu') and got.dtype == torch.float32
  assert float(got) == float(port_metrics.crps_ensemble(y, samples))
  assert float(port_metrics.rmse(as_t(y), loc)) == float(
      port_metrics.rmse(y, loc))
