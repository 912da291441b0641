"""Calendar math: pandas frequency strings -> float seasonal periods.

A copy of `bayesnf_tpu/calendar.py` (pure numpy/pandas, so the port shares
its behaviour exactly), which mirrors the upstream BayesNF seasonality
helpers (`bayesnf/spatiotemporal.py:31-95`): a seasonality
expressed as a pandas frequency alias (e.g. ``'Y'``) is converted to a float
number of data-frequency steps (e.g. 52.25 weeks per year), using a
leap-year-averaged four-year window.

This layer is pure host code (pandas at the edge only); nothing here touches
a device.
"""

from collections.abc import Sequence

import numpy as np
import pandas as pd


def seasonality_to_float(seasonality: str, freq: str) -> float:
  """Convert a pandas frequency alias to a float period relative to `freq`.

  Counts how many `freq` steps span a four-year window starting 2020-01-01
  (so leap years average out) and how many `seasonality` periods span the
  same window, and returns the ratio.

  Examples:
    >>> seasonality_to_float('Y', 'D')
    365.25
    >>> seasonality_to_float('Y', 'W')
    52.25
    >>> seasonality_to_float('M', 'D')
    30.4375

  Args:
    seasonality: A valid pandas frequency alias (the long period).
    freq: A valid pandas frequency alias (the data sampling rate). Should be
      shorter than `seasonality`.

  Returns:
    How many `freq` steps one `seasonality` period spans, on average.
  """
  four_years = pd.date_range('2020-01-01', periods=5, freq='YS')
  season_periods = four_years.to_period(seasonality)
  num_seasonality = (season_periods[-1] - season_periods[0]).n

  days = pd.date_range(
      season_periods[0].start_time, season_periods[-1].start_time
  ).to_period(freq)
  num_freq = (days[-1] - days[0]).n

  return num_freq / num_seasonality


def seasonalities_to_array(
    seasonalities: Sequence[float | str], freq: str
) -> np.ndarray:
  """Convert floats/frequency-strings to float periods relative to `freq`.

  Args:
    seasonalities: Durations relative to `freq`: floats are passed through,
      strings are converted with :func:`seasonality_to_float`.
    freq: Frequency alias of the data.

  Raises:
    TypeError: If any seasonality resolves to a period <= 1 `freq` step.

  Returns:
    Array of float periods, each > 1.
  """
  out = []
  for seasonality in seasonalities:
    if isinstance(seasonality, str):
      period = seasonality_to_float(seasonality, freq)
      if period < 1:
        raise TypeError(
            f'seasonality {seasonality!r} is only {period:.2f} steps of '
            f'freq {freq!r}; a seasonal period must span more than one '
            'data step.'
        )
    else:
      period = seasonality
      if period < 1:
        raise TypeError(
            f'numeric seasonality {period} must exceed 1 (it is measured '
            'in data steps).'
        )
    out.append(period)
  return np.array(out)
