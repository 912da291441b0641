"""Synthetic ground-truth spatiotemporal series (known generative field)
(counterpart of `bayesnf_tpu/cli/synthetic.py`, a copy: pure numpy and
pandas, with the same `LOCATIONS` and draws).

The bundled chickenpox-8 series is confounded for *test-region*
comparison (100 rows, one county — PARITY.md §3), so quality comparisons
that need an unconfounded held-out region run on this generator instead:
a smooth seasonal-plus-spatial field over several locations, sampled
under each observation model, with the TRUE conditional mean carried per
row. The executed baseline head-to-head (`cli/baseline_headtohead.py`)
consumes it.

The held-out rows are randomly interleaved in time and space (not a
future block): this is a field-recovery protocol, not a forecasting
benchmark.
"""

import numpy as np
import pandas as pd

LOCATIONS = {
    'A': (46.5, 19.4),
    'B': (47.2, 18.1),
    'C': (46.1, 20.3),
    'D': (47.6, 19.9),
    'E': (46.9, 17.7),
    'F': (46.3, 21.2),
}


def make_series(observation_model, seed=0, n_weeks=156):
  """Long-format (train_df, test_df) from a known seasonal+spatial field.

  Columns: location, datetime, latitude, longitude, y, true_mean (the
  generative conditional mean — lets point predictions be scored without
  the observation-noise floor).
  """
  rng = np.random.default_rng(seed)
  dates = pd.date_range('2015-01-05', periods=n_weeks, freq='W-MON')
  rows = []
  for loc, (lat, lon) in LOCATIONS.items():
    t = np.arange(n_weeks)
    field = (
        2.0 * np.sin(2 * np.pi * t / 52.0)
        + 1.0 * np.cos(2 * np.pi * t / 13.0)
        + 0.8 * (lat - 46.6)
        + 0.5 * (lon - 19.3) * np.sin(2 * np.pi * t / 52.0)
    )
    if observation_model == 'NORMAL':
      true_mean = field
      # Noise comparable to the field spread: held-out intervals are then
      # aleatoric-dominated, so the learned noise scale (not the ensemble
      # spread) determines coverage and 95% is achievable at small budgets.
      y = field + 1.0 * rng.normal(size=n_weeks)
    else:
      # Count target: Poisson around a positive transform of the field
      # (a mean the NB/ZINB parametrization can represent).
      mean = np.exp(0.6 * field + 2.0)
      y = rng.poisson(mean).astype(np.float64)
      true_mean = mean
      if observation_model == 'ZINB':
        zero = rng.uniform(size=n_weeks) < 0.1
        y[zero] = 0.0
        true_mean = 0.9 * mean
    for i, d in enumerate(dates):
      rows.append(dict(
          location=loc, datetime=d, latitude=lat, longitude=lon, y=y[i],
          true_mean=true_mean[i],
      ))
  df = pd.DataFrame(rows)
  df.index = np.arange(len(df))
  holdout = rng.uniform(size=len(df)) < 0.2
  return df[~holdout].copy(), df[holdout].copy()
