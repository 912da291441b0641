"""The port's spans and counters (`bayesnf_torch/utils/profiling.py`) on
the CPU.

- With no profiler recording, the spans' table and the counters stay
  empty.
- Under `torch.profiler` (CPU activity), a MAP `train` and a VI `train` over
  two ensemble groups on the 'kernel' path (the plain K1 on CPU tensors),
  an estimator `predict`, and the forward's chunks on the 'kernel' path
  (the plain K2), record the span tree: the counts of steps, groups,
  quantiles and chunks, self time within host time, and each child's
  `user_annotation` inside its parent's in the exported trace.
- Means, quantiles, losses and parameters are bit for bit the same with
  the profiler on and off.
- The root-find's iterations needed are at most those run, and a search
  stopped at the needed count returns the same roots bit for bit.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch
import torch.profiler

import bayesnf_torch
from bayesnf_torch.inference import map as t_map
from bayesnf_torch.inference import predict as t_predict
from bayesnf_torch.inference import quantiles as t_quantiles
from bayesnf_torch.inference import vi as t_vi
from bayesnf_torch.models import field as t_field
from bayesnf_torch.models import likelihoods as t_likelihoods
from bayesnf_torch.ops import special as t_special
from bayesnf_torch.parallel import mesh as t_mesh
from bayesnf_torch.utils import profiling

torch.set_num_threads(1)

NORMAL = t_likelihoods.LikelihoodDist.NORMAL
CONFIG = t_field.FieldConfig.create(
    width=8, depth=2, input_scales=[50.0, 1.0, 1.0],
    fourier_degrees=[2, 2, 0], interactions=[(1, 2)],
    seasonality_periods=[7.0], num_seasonal_harmonics=[2])
ROWS, MEMBERS, GROUPS, STEPS, BATCH, DRAWS = 60, 4, 2, 3, 20, 2
QUANTILES = (0.5, 0.1, 0.9)
PREDICT_ROWS = 96  # 24 hours of 4 sites.
CHUNK = 32
# Each span's parent, where the test's call opens the parent too.
PARENTS = {
    'bnf.predict.handler': 'bnf.predict',
    'bnf.predict.forward': 'bnf.predict',
    'bnf.predict.encode': 'bnf.predict.forward',
    'bnf.predict.summaries': 'bnf.predict',
    'bnf.predict.quantile': 'bnf.predict',
    'bnf.fit.step': 'bnf.fit',
    'bnf.fit.draws': 'bnf.fit.step',
    'bnf.fit.batch': 'bnf.fit.step',
    'bnf.fit.loss': 'bnf.fit.step',
    'bnf.fit.backward': 'bnf.fit.step',
    'bnf.fit.adam': 'bnf.fit.step',
    'bnf.k1': 'bnf.fit.loss',
}


def _rows():
  """(aug_t (D + 2F, N), y (N,)) of a small synthetic table."""
  rng = np.random.default_rng(0)
  x = (rng.normal(size=(ROWS, 3)) * 5).astype(np.float32)
  y = (np.sin(x[:, 0]) + x[:, 1]).astype(np.float32)
  aug = t_field.aug_features(CONFIG, torch.as_tensor(x))
  return aug.T.contiguous(), torch.as_tensor(y)


def _mesh():
  return t_mesh.default_mesh(['cpu'] * GROUPS, ensemble_devices=GROUPS)


def _map_train():
  aug_t, y = _rows()
  params = t_map.init_ensemble(CONFIG, MEMBERS, 0, 0.0, 'cpu')
  out = t_map.train(params, t_map.init_opt_state(params), aug_t, y, CONFIG,
                    NORMAL, 0.01, STEPS, backend='kernel', mesh=_mesh())
  return [*out[0], out[2]]


def _vi_train():
  aug_t, y = _rows()
  surrogate = t_vi.init_surrogate(CONFIG, MEMBERS, 0, 'cpu')
  state = t_map.init_opt_state((*surrogate[0], *surrogate[1]))
  generator = torch.Generator().manual_seed(3)
  out = t_vi.train(surrogate, state, aug_t, y, CONFIG, NORMAL, 0.01, STEPS,
                   BATCH, DRAWS, 0.5, generator, 'kernel', mesh=_mesh())
  return [*out[0][0], *out[0][1], out[2]]


def _table(n_hours, seed):
  rng = np.random.default_rng(seed)
  sites = rng.normal(size=(4, 2))
  times = pd.date_range('2021-03-01', periods=n_hours, freq='h')
  df = pd.DataFrame([(t, lat, lon) for t in times for lat, lon in sites],
                    columns=['datetime', 'lat', 'lon'])
  df['y'] = np.sin(np.arange(len(df)) / 8.0) + df['lat']
  return df


@pytest.fixture(scope='module')
def estimator():
  est = bayesnf_torch.BayesianNeuralFieldMAP(
      feature_cols=['datetime', 'lat', 'lon'], target_col='y',
      timetype='index', freq='h', standardize=['lat', 'lon'], width=8,
      depth=2, seasonality_periods=[24], num_seasonal_harmonics=[2])
  return est.fit(_table(24, 0), seed=0, ensemble_size=3, num_epochs=5,
                 device='cpu')


def _predict(est):
  means, quantiles = est.predict(_table(PREDICT_ROWS // 4, 1),
                                 quantiles=QUANTILES, backend='torch')
  return [means, *quantiles]


def _chunks():
  """The forward of PREDICT_ROWS rows in CHUNK-row chunks on the 'kernel'
  path, which runs the plain K2 on CPU tensors."""
  params = t_map.init_ensemble(CONFIG, MEMBERS, 0, 0.0, 'cpu')
  features = torch.as_tensor(np.random.default_rng(2).normal(
      size=(PREDICT_ROWS - 5, 3)).astype(np.float32))
  return list(t_predict._padded_forecast_params(  # pylint: disable=protected-access
      CONFIG, NORMAL, params, features, CHUNK, 'kernel', None))


def _expected(case):
  """The calls each span of `case` makes."""
  groups = STEPS * GROUPS
  fit = {'bnf.fit': 1, 'bnf.fit.step': STEPS, 'bnf.fit.batch': groups,
         'bnf.fit.loss': groups, 'bnf.fit.adam': groups, 'bnf.k1': groups}
  return {
      'map': fit,
      'vi': dict(fit, **{'bnf.fit.draws': STEPS, 'bnf.fit.backward': groups}),
      'predict': {'bnf.predict': 1, 'bnf.predict.handler': 1,
                  'bnf.predict.forward': 1, 'bnf.predict.encode': 1,
                  'bnf.predict.summaries': 1,
                  'bnf.predict.quantile': len(QUANTILES)},
      'chunks': {'bnf.k2': PREDICT_ROWS // CHUNK,
                 'bnf.predict.encode': PREDICT_ROWS // CHUNK},
  }[case]


def _run(case, est):
  return {'map': _map_train, 'vi': _vi_train, 'chunks': _chunks,
          'predict': lambda: _predict(est)}[case]()


def _profiled(fn, trace_path=None):
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
    out = fn()
  if trace_path is not None:
    prof.export_chrome_trace(str(trace_path))
  return out


CASES = ['map', 'vi', 'predict', 'chunks']


def test_nothing_is_recorded_without_a_profiler(estimator):
  profiling.reset()
  for case in CASES:
    _run(case, estimator)
  assert not profiling.recording()
  assert profiling.span_table() == {}
  assert profiling.counters() == {}


@pytest.mark.parametrize('case', CASES)
def test_the_profiler_records_the_span_tree(estimator, case, tmp_path):
  profiling.reset()
  path = tmp_path / 'trace.json'
  _profiled(lambda: _run(case, estimator), path)
  table = profiling.span_table()
  assert {k: v.calls for k, v in table.items()} == _expected(case)
  for stats in table.values():
    assert 0 <= stats.self_s <= stats.host_s
  for parent in set(PARENTS.values()) & set(table):
    children = sum(table[k].host_s for k, p in PARENTS.items()
                   if p == parent and k in table)
    assert children <= table[parent].host_s
  events = [e for e in json.loads(path.read_text())['traceEvents']
            if e.get('cat') == 'user_annotation'
            and e['name'].startswith('bnf.')]
  assert sorted({e['name'] for e in events}) == sorted(_expected(case))
  for e in events:
    parent = PARENTS.get(e['name'])
    if parent not in table:
      continue
    assert any(p['name'] == parent and p['ts'] <= e['ts']
               and e['ts'] + e['dur'] <= p['ts'] + p['dur']
               for p in events), e['name']
  counts = profiling.counters()
  if case == 'predict':
    assert counts[t_quantiles.ITERATIONS_RUN] == 60 * len(QUANTILES)
    assert 0 < counts[t_quantiles.ITERATIONS_NEEDED] <= 60 * len(QUANTILES)
  else:
    assert counts == {}
  profiling.reset()
  assert profiling.span_table() == {} and profiling.counters() == {}


@pytest.mark.parametrize('case', CASES)
def test_results_are_bit_for_bit_with_the_profiler_on(estimator, case):
  off = _run(case, estimator)
  on = _profiled(lambda: _run(case, estimator))
  profiling.reset()
  assert len(on) == len(off)
  for a, b in zip(on, off):
    assert torch.equal(a, b)


def _mixture(seed, members, rows):
  rng = np.random.default_rng(seed)
  means = torch.as_tensor(rng.normal(size=(1, members, rows)) * 3,
                          dtype=torch.float32)
  scales = torch.as_tensor(rng.uniform(0.2, 2.0, size=(1, members, 1)),
                           dtype=torch.float32)
  return means, scales


@pytest.mark.parametrize('seed, members, rows, q', [
    (0, 5, 130, 0.5), (1, 30, 256, 0.975), (2, 1, 7, 0.025)])
def test_the_search_stopped_when_every_lane_converged_is_the_same(
    seed, members, rows, q):
  means, scales = _mixture(seed, members, rows)
  low = means.min() - 5 * scales.max()
  high = means.max() + 5 * scales.max()

  def f(x):
    return t_quantiles.member_mean(
        t_special.normal_cdf(x, means, scales), (0, 1)) - q

  profiling.reset()
  full = _profiled(lambda: t_quantiles.find_root_chandrupatla(
      f, low, high, max_iterations=60))
  counts = profiling.counters()
  profiling.reset()
  needed = counts[t_quantiles.ITERATIONS_NEEDED]
  assert counts[t_quantiles.ITERATIONS_RUN] == 60
  assert 0 < needed <= 60
  short = t_quantiles.find_root_chandrupatla(f, low, high,
                                             max_iterations=needed)
  assert torch.equal(short, full)
