"""Host-side data layer: long-format pandas DataFrames -> float matrices.

The counterpart of `bayesnf_tpu/data.py` (numpy/pandas): both packages
turn a table into the same matrix, bit for bit, though this one takes the
period index from the `PeriodArray`'s int64 ordinals in one vectorised
step where the JAX package reads each row's `Period`. Behavioral parity
surface (upstream BayesNF `SpatiotemporalDataHandler`,
`bayesnf/spatiotemporal.py:98-192` — same observable behavior,
independently structured implementation):

- rows with NaN targets are dropped; a missing time (``NaT``) raises,
- the time column is converted either to an integer period index relative to
  2020-01-01 (``timetype='index'``) or to raw floats (``timetype='float'``),
  then shifted so the training minimum is zero,
- selected columns are z-scored with *train-time* statistics which are reused
  verbatim at test time,
- the time scale (max training time value) becomes the time input scale.

Everything downstream of this module consumes plain ``(N, D)`` float32
matrices; pandas never reaches device code.

While a profiler records (`utils/profiling.py`), ``time_to_numeric`` adds
the rows it turns into period indices to the counter ``PERIOD_ROWS``.
"""

from collections.abc import Sequence

import numpy as np
import pandas as pd

from bayesnf_torch.utils import profiling

# Counter of the time values converted to period indices.
PERIOD_ROWS = 'bnf.handler.period_rows'

# Origin of the integer period index. Any fixed date works (times are
# re-based to the training minimum afterwards); this one keeps the
# intermediate integers identical to the reference's.
_PERIOD_ORIGIN = '2020-01-01'


def time_to_numeric(col: pd.Series, timetype: str, freq: str | None):
  """Raw (unshifted) numeric values for a time column.

  ``timetype='index'`` counts `freq`-periods since ``_PERIOD_ORIGIN`` as
  integers (so e.g. weekly data maps consecutive weeks to consecutive
  ints); ``'float'`` takes the values as-is.

  Raises:
    ValueError: if ``timetype='index'`` and a time is missing (``NaT``).
  """
  if timetype == 'float':
    return col.astype(float)
  if timetype == 'index':
    periods = col.dt.to_period(freq).array
    if periods.isna().any():
      raise ValueError(
          f'the time column {col.name!r} has missing times (NaT), which '
          'have no period index'
      )
    if profiling.recording():
      profiling.count(PERIOD_ROWS, len(periods))
    origin = pd.Timestamp(_PERIOD_ORIGIN).to_period(freq).ordinal
    # The PeriodArray's int64 ordinals count periods since pandas' own
    # epoch, so their difference from `origin`'s is the count since it.
    return pd.Series(periods.asi8 - origin, index=col.index, name=col.name)
  raise ValueError(
      f"timetype must be 'index' or 'float', got {timetype!r}"
  )


class SpatiotemporalDataHandler:
  """Prepares long-format spatiotemporal tables for training/prediction.

  ``get_train`` fits the state (``time_min_``, ``time_scale_``, ``mu_``,
  ``std_``); ``get_test`` replays it on new rows. Column 0 of
  ``feature_cols`` is always the time column.
  """

  def __init__(
      self,
      feature_cols: Sequence[str],
      target_col: str,
      timetype: str,
      freq: str | None,
      standardize: Sequence[str] | None = None,
  ):
    self.feature_cols = list(feature_cols)
    self.target_col = target_col
    self.timetype = timetype
    self.freq = freq
    self.standardize = standardize
    self.mu_ = None
    self.std_ = None
    self.time_min_ = None
    self.time_scale_ = None

  @property
  def _time_idx(self) -> int:
    return 0

  @property
  def _time_column(self) -> str:
    return self.feature_cols[self._time_idx]

  def _drop_nan_targets(self, table: pd.DataFrame) -> pd.DataFrame:
    # Tables without the target column (pure prediction grids) pass through.
    if self.target_col not in table.columns:
      return table
    return table[table[self.target_col].notna()]

  # Back-compat aliases for the reference's method names (thin; the logic
  # lives in `_drop_nan_targets`).
  def _maybe_filter_target_nans(self, table: pd.DataFrame) -> pd.DataFrame:
    return self._drop_nan_targets(table)

  def copy_and_filter_table(self, table: pd.DataFrame) -> pd.DataFrame:
    return self._drop_nan_targets(table.copy())

  def get_target(self, table: pd.DataFrame) -> np.ndarray:
    return self._drop_nan_targets(table)[self.target_col].values

  def _assemble(self, table: pd.DataFrame, *, fit: bool) -> np.ndarray:
    """Build the (N, D) feature matrix; with `fit`, record the stats."""
    times = time_to_numeric(table[self._time_column], self.timetype, self.freq)
    if fit:
      self.time_min_ = times.min()
    table = table.assign(**{self._time_column: times - self.time_min_})
    features = table[self.feature_cols].values

    if fit:
      self.time_scale_ = features[:, self._time_idx].max()
      self.mu_ = np.zeros(len(self.feature_cols))
      self.std_ = np.ones(len(self.feature_cols))
      if self.standardize:
        if self._time_column in self.standardize:
          raise TypeError(
              'the time column is never z-scored (its scale feeds the '
              "Fourier encoder); remove it from `standardize`"
          )
        idx = [self.feature_cols.index(name) for name in self.standardize]
        cols = features[:, idx].astype(float)
        self.mu_[idx] = cols.mean(axis=0)
        self.std_[idx] = cols.std(axis=0)

    if self.standardize:
      features = (features - self.mu_) / self.std_
    return features

  def get_train(self, table: pd.DataFrame) -> np.ndarray:
    """Fetch the training feature matrix; fits time offset + z-score stats."""
    return self._assemble(self.copy_and_filter_table(table), fit=True)

  def get_test(self, table: pd.DataFrame) -> np.ndarray:
    """Fetch a test feature matrix, reusing train-time stats.

    NaN-target rows are intentionally kept (prediction grids routinely
    carry no target), matching the reference's `get_test`.
    """
    return self._assemble(table.copy(), fit=False)

  def get_input_scales(self) -> np.ndarray:
    """Per-feature input scales: time scale for column 0, 1.0 elsewhere."""
    scales = np.ones(len(self.feature_cols))
    scales[self._time_idx] = self.time_scale_
    return scales
