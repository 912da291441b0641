"""A monthly table at the sst dataset's published shape: months over a
grid of 1,317 locations, with a per-month Southern Oscillation Index input
(`soi`) and a sea-surface temperature target (`sst`).

A frozen copy of `bench_torch.sst_table`.
"""

import numpy as np
import pandas as pd

LOCATIONS = 1_317  # x 168 months covers the dataset's 221,127 rows.


def make(rows, seed, locations=LOCATIONS):
  rng = np.random.default_rng(seed)
  months = -(-rows // locations)
  lat = rng.uniform(-60, 60, size=locations)
  lon = rng.uniform(0, 360, size=locations)
  soi = rng.normal(size=months)
  month = np.repeat(np.arange(months), locations)[:rows]
  where = np.tile(np.arange(locations), months)[:rows]
  sst = (15 + 10 * np.cos(np.radians(lat[where]))
         + 2 * np.sin(2 * np.pi * month / 12) + 0.5 * soi[month]
         + 0.3 * rng.normal(size=rows))
  return pd.DataFrame({
      'datetime': pd.period_range('2000-01', periods=months,
                                  freq='M').to_timestamp()[month],
      'latitude': lat[where], 'longitude': lon[where], 'soi': soi[month],
      'sst': sst,
  })
