"""Which quantile search `predict.quantile_rows` takes, on the CPU.

The search kernel (`ops/mixture_quantile.py`) runs on a card only; its
results are held to the plain search in `tests/test_torch_gpu.py`. Here:

- the 'torch' backend, the count models and approximate quantiles take the
  plain search, bit for bit as a direct call of it over the valid rows
  rounded up to `SEARCH_ROWS`, whatever the backend;
- the exact NORMAL quantiles under 'kernel' make one call of the kernel's
  wrapper on the valid rows, in one `bnf.predict.quantile` span, counting
  its quantiles in `bnf.rootfind.kernel_searches` and its iterations as run
  and needed alike;
- the wrapper refuses CPU tensors.
"""

import numpy as np
import pytest
import torch
import torch.profiler

from bayesnf_torch.inference import predict as t_predict
from bayesnf_torch.inference import quantiles as t_quantiles
from bayesnf_torch.models import distributions as t_dist
from bayesnf_torch.ops import mixture_quantile
from bayesnf_torch.utils import profiling

torch.set_num_threads(1)

QS = (0.5, 0.025, 0.975)
ENS = (2, 3)
ROWS = 130  # Forward rows (padded); the first VALID are searched.
VALID = 100


def _fp(distribution, seed=0):
  """Flat forecast parameters (6 members) of `distribution` over ROWS rows,
  and the bracket statistics of their first VALID rows."""
  rng = np.random.default_rng(seed)
  k = int(np.prod(ENS))

  def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))

  if distribution == 'NORMAL':
    fp = (t(rng.normal(scale=3.0, size=(k, ROWS))),
          t(rng.uniform(0.2, 2.0, size=k)))
  else:
    fp = (t(rng.uniform(2.0, 8.0, size=k)),
          t(rng.normal(scale=0.5, size=(k, ROWS))))
    if distribution == 'ZINB':
      fp += (t(np.broadcast_to(rng.uniform(0.05, 0.3, size=(k, 1)),
                               (k, ROWS))),)
  _, stats = t_predict.summaries(distribution, fp, VALID)
  return fp, stats


def _plain(distribution, fp, approximate, stats):
  """The plain search as `quantile_rows` made it before it had a kernel
  path: the valid rows rounded up to SEARCH_ROWS, cut to VALID after."""
  searched = -(-VALID // t_predict.SEARCH_ROWS) * t_predict.SEARCH_ROWS
  fp = tuple(f if f.ndim == 1 else f[:, :searched] for f in fp)

  def expand(leaf):
    return leaf.reshape(ENS + tuple(leaf.shape[1:]))

  if distribution == 'NORMAL':
    q = t_quantiles.normal_mixture_quantiles(
        expand(fp[0]), expand(fp[1]), QS, (0, 1), approximate, stats=stats)
  else:
    obs_d = t_dist.count_obs_dist(*(expand(f) for f in fp))
    q = [t_quantiles.count_mixture_quantile_root(obs_d, q, (0, 1), stats)
         for q in QS]
  return torch.stack(q)[:, :VALID]


@pytest.mark.parametrize('distribution,approximate,backend', [
    ('NORMAL', False, 'torch'), ('NORMAL', True, 'torch'),
    ('NORMAL', True, 'kernel'), ('NB', False, 'torch'),
    ('NB', False, 'kernel'), ('ZINB', False, 'kernel'),
])
def test_quantile_rows_takes_the_plain_search(monkeypatch, distribution,
                                              approximate, backend):
  def refuse(*args, **kwargs):
    raise AssertionError('the search kernel was called')

  monkeypatch.setattr(mixture_quantile, 'mixture_quantiles', refuse)
  fp, stats = _fp(distribution)
  got = t_predict.quantile_rows(distribution, fp, ENS, QS, approximate,
                                stats, VALID, backend)
  assert tuple(got.shape) == (len(QS), VALID)
  assert torch.equal(got, _plain(distribution, fp, approximate, stats))


def test_quantile_rows_sends_exact_normal_quantiles_to_the_kernel(
    monkeypatch):
  fp, stats = _fp('NORMAL')
  calls = []

  def fake(means, scales, quantiles, stats_, most=None):
    calls.append((means, scales, tuple(quantiles), stats_, most))
    if most is not None:
      most.fill_(7)
    return torch.full((len(quantiles), means.shape[1]), 0.25)

  monkeypatch.setattr(mixture_quantile, 'mixture_quantiles', fake)
  profiling.reset()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    got = t_predict.quantile_rows('NORMAL', fp, ENS, QS, False, stats,
                                  VALID, 'kernel')
  table = profiling.span_table()
  counts = profiling.counters()
  profiling.reset()
  (means, scales, quantiles, stats_, most), = calls
  assert means.data_ptr() == fp[0].data_ptr()  # A view: no copy of rows.
  assert tuple(means.shape) == (6, VALID) and means.stride() == (ROWS, 1)
  assert torch.equal(scales, fp[1]) and quantiles == QS
  assert torch.equal(stats_[0], stats[0]) and torch.equal(stats_[1], stats[1])
  assert torch.equal(stats_[2], torch.amax(fp[1]))
  assert tuple(most.shape) == (len(QS),) and most.dtype == torch.int32
  assert {k: v.calls for k, v in table.items()} == {'bnf.predict.quantile': 1}
  assert counts == {t_quantiles.ITERATIONS_RUN: 7 * len(QS),
                    t_quantiles.ITERATIONS_NEEDED: 7 * len(QS),
                    t_quantiles.KERNEL_SEARCHES: len(QS)}
  assert torch.equal(got, torch.full((len(QS), VALID), 0.25))
  # Off the profiler no counter is asked for.
  t_predict.quantile_rows('NORMAL', fp, ENS, QS, False, stats, VALID,
                          'kernel')
  assert calls[-1][-1] is None and profiling.counters() == {}


@pytest.mark.parametrize('fault', ['none', 'float64', 'scales', 'stats'])
def test_kernel_wrapper_refuses_cpu_tensors(fault):
  fp, (lo, hi) = _fp('NORMAL')
  means, scales, stats = fp[0], fp[1], (lo, hi, torch.amax(fp[1]))
  if fault == 'float64':
    means = means.double()
  elif fault == 'scales':
    scales = scales[:-1]
  elif fault == 'stats':
    stats = stats[:2]
  before = mixture_quantile.mixture_quantiles.launches
  with pytest.raises(ValueError, match='float32 CUDA means'):
    mixture_quantile.mixture_quantiles(means, scales, QS, stats)
  assert mixture_quantile.mixture_quantiles.launches == before
