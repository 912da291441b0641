"""Host milliseconds per predict call in the mixture quantiles' searches:
the program's `bnf.predict.quantile` spans (one Chandrupatla search each),
from its span table (`utils/profiling.span_table`) over both profiled
stretches, over the table's own count of `bnf.predict` calls. Read in a
traced run whose stretches ran on the device; nothing where the program
keeps no span table."""

from bayesnf_torch.utils import profiling


def read(reading, shapes):
  del shapes
  table = getattr(profiling, 'span_table', dict)()
  outer = table.get('bnf.predict')
  if reading.busy_s <= 0 or outer is None or outer.calls <= 0:
    return None
  inner = table.get('bnf.predict.quantile')
  return 1e3 * (inner.host_s if inner else 0.0) / outer.calls
