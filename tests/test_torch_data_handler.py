"""The port's data handler against `bayesnf_tpu`'s, on the CPU.

`bayesnf_torch.data.SpatiotemporalDataHandler` takes a time column's
period index from the `PeriodArray`'s int64 ordinals in one vectorised
step; the JAX package's handler reads each row's `Period.ordinal`. Both
must give the same float64 matrices bit for bit, and the same train-time
statistics, at every period frequency, datetime unit and table shape the
estimators take. A missing time (`NaT`) has no period index: the port
raises `ValueError` naming the column, and the JAX package raises too.
"""

import numpy as np
import pandas as pd
import pytest

from bayesnf_torch import data as t_data
from bayesnf_tpu import data as j_data

SITES = 3


def _table(start, periods, freq, *, seed, unit='ns', tz=None, target=True):
  """A long table of `SITES` sites over `periods` times from `start`, with
  a covariate and (with `target`) a target that is NaN on a few rows."""
  rng = np.random.default_rng(seed)
  times = pd.date_range(start, periods=periods, freq=freq, tz=tz).as_unit(unit)
  sites = rng.normal(size=(SITES, 2)) * [3.0, 40.0] + [50.0, -8.0]
  rows = [(t, lat, lon) for t in times for lat, lon in sites]
  df = pd.DataFrame(rows, columns=['datetime', 'lat', 'lon'])
  df['elev'] = rng.gamma(2.0, 150.0, size=len(df))
  if target:
    df['y'] = rng.normal(size=len(df))
    df.loc[rng.choice(len(df), size=len(df) // 10, replace=False), 'y'] = (
        np.nan)
  # A shuffled, non-default index: the handlers keep a table's own rows.
  return df.sample(frac=1.0, random_state=seed).set_index(
      rng.permutation(len(df)) * 7 + 11)


# (train table, test grid, timetype, freq, standardize) of each case.
CASES = {
    'hourly': (dict(start='2021-03-01 05:00', periods=200, freq='h'),
               dict(start='2021-03-05', periods=300, freq='h'),
               'index', 'h', None),
    'daily': (dict(start='2019-11-20', periods=120, freq='D'),
              dict(start='2020-01-10', periods=150, freq='D'),
              'index', 'D', None),
    'weekly': (dict(start='2018-06-03', periods=60, freq='W'),
               dict(start='2018-09-02', periods=80, freq='W'),
               'index', 'W', None),
    'monthly': (dict(start='1990-01-01', periods=96, freq='MS'),
                dict(start='1994-07-01', periods=72, freq='MS'),
                'index', 'M', None),
    'unit_s': (dict(start='2021-03-01', periods=100, freq='h', unit='s'),
               dict(start='2021-03-03', periods=100, freq='h', unit='s'),
               'index', 'h', None),
    'unit_ns': (dict(start='2021-03-01', periods=100, freq='D', unit='ns'),
                dict(start='2021-03-20', periods=100, freq='D', unit='ns'),
                'index', 'D', None),
    'tz_aware': (dict(start='2021-03-25', periods=120, freq='h',
                      tz='Europe/Dublin'),
                 dict(start='2021-03-27', periods=120, freq='h',
                      tz='Europe/Dublin'),
                 'index', 'h', None),
    'standardize': (dict(start='2021-03-01', periods=100, freq='D'),
                    dict(start='2021-04-01', periods=100, freq='D'),
                    'index', 'D', ['lat', 'lon', 'elev']),
    # The grid starts before the training minimum: shifted times < 0.
    'before_train': (dict(start='2021-03-01', periods=100, freq='h'),
                     dict(start='2021-02-20', periods=200, freq='h'),
                     'index', 'h', ['lat']),
}


def _tables(case):
  if case == 'float':
    train = _table('2021-03-01', 80, 'h', seed=5)
    test = _table('2021-02-27', 120, 'h', seed=6, target=False)
    for df in (train, test):
      df['datetime'] = (df['datetime'] - pd.Timestamp('2021-01-01')) / (
          pd.Timedelta(hours=1)) + 0.25
    return train, test, 'float', None, ['elev']
  train_kw, test_kw, timetype, freq, standardize = CASES[case]
  train = _table(**train_kw, seed=1)
  test = _table(**test_kw, seed=2, target=False)
  return train, test, timetype, freq, standardize


def _handlers(timetype, freq, standardize):
  args = (['datetime', 'lat', 'lon', 'elev'], 'y', timetype, freq)
  return (t_data.SpatiotemporalDataHandler(*args, standardize=standardize),
          j_data.SpatiotemporalDataHandler(*args, standardize=standardize))


def _assert_same(a, b):
  assert a.dtype == b.dtype and a.shape == b.shape
  assert np.array_equal(a, b)


@pytest.mark.filterwarnings('ignore:Converting to PeriodArray')
@pytest.mark.parametrize('case', [*CASES, 'float'])
def test_matrices_and_statistics_are_the_reference_handlers(case):
  train, test, timetype, freq, standardize = _tables(case)
  port, ref = _handlers(timetype, freq, standardize)
  _assert_same(port.get_train(train), ref.get_train(train))
  _assert_same(port.get_test(test), ref.get_test(test))
  _assert_same(port.get_target(train), ref.get_target(train))
  _assert_same(port.get_input_scales(), ref.get_input_scales())
  assert type(port.time_min_) is type(ref.time_min_)
  assert port.time_min_ == ref.time_min_
  assert type(port.time_scale_) is type(ref.time_scale_)
  assert port.time_scale_ == ref.time_scale_
  _assert_same(port.mu_, ref.mu_)
  _assert_same(port.std_, ref.std_)
  if case == 'before_train':
    assert port.get_test(test)[:, 0].min() < 0


@pytest.mark.parametrize('step', ['get_train', 'get_test'])
def test_a_missing_time_raises(step):
  train, test, timetype, freq, standardize = _tables('hourly')
  port, ref = _handlers(timetype, freq, standardize)
  port.get_train(train)
  ref.get_train(train)
  table = (train if step == 'get_train' else test).copy()
  table.iloc[3, table.columns.get_loc('datetime')] = pd.NaT
  with pytest.raises(ValueError, match="'datetime'"):
    getattr(port, step)(table)
  with pytest.raises(Exception):
    getattr(ref, step)(table)
