"""An hourly table at the air_quality dataset's published shape: one row an
hour, two coordinates a row, a seasonal target (`pm10`).

A frozen copy of `bench_torch.hourly_table` (itself bench.py's workload),
without its count-target option.
"""

import numpy as np
import pandas as pd


def make(rows, seed):
  rng = np.random.default_rng(seed)
  t = np.arange(rows)
  space = rng.normal(size=(rows, 2))
  y = (10 * np.sin(2 * np.pi * t / 24.0)
       + 3 * np.sin(2 * np.pi * t / (24.0 * 7))
       + space[:, 0] + rng.normal(size=rows))
  return pd.DataFrame({
      'datetime': pd.Timestamp('2021-01-01') + pd.to_timedelta(t, unit='h'),
      'latitude': space[:, 0], 'longitude': space[:, 1], 'pm10': y,
  })
