"""A daily table at the wind dataset's published shape: one row a day at
each of 12 stations from 1961-01-01 (Haslett and Raftery's Irish daily wind
speeds, 1961-1978, as R's gstat ships them), two coordinates a row, and a
wind-speed target (`wind`) with weekly and yearly cycles plus noise.
"""

import numpy as np
import pandas as pd

STATIONS = 12  # x 6,574 days covers the dataset's 78,888 rows.
START = '1961-01-01'


def make(rows, seed, stations=STATIONS):
  rng = np.random.default_rng(seed)
  days = -(-rows // stations)
  lat = rng.uniform(51.5, 55.5, size=stations)
  lon = rng.uniform(-10.5, -6.0, size=stations)
  level = rng.uniform(8.0, 16.0, size=stations)
  day = np.repeat(np.arange(days), stations)[:rows]
  where = np.tile(np.arange(stations), days)[:rows]
  wind = (level[where] + 3 * np.cos(2 * np.pi * day / 365.25)
          + 0.5 * np.sin(2 * np.pi * day / 7) + 2 * rng.normal(size=rows))
  return pd.DataFrame({
      'datetime': pd.Timestamp(START) + pd.to_timedelta(day, unit='D'),
      'latitude': lat[where], 'longitude': lon[where], 'wind': wind,
  })
