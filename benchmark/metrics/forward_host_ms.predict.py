"""Host milliseconds per predict call in the forward: the program's
`bnf.predict.forward` span (the copy to the device, padding, the seasonal
features, each chunk's encode, K2 and forecast parameters, the joins),
from its span table (`utils/profiling.span_table`) over both profiled
stretches, over the table's own count of `bnf.predict` calls. K2 runs
asynchronously, so this is the host's share. Read in a traced run whose
stretches ran on the device; nothing where the program keeps no span
table."""

from bayesnf_torch.utils import profiling


def read(reading, shapes):
  del shapes
  table = getattr(profiling, 'span_table', dict)()
  outer = table.get('bnf.predict')
  if reading.busy_s <= 0 or outer is None or outer.calls <= 0:
    return None
  inner = table.get('bnf.predict.forward')
  return 1e3 * (inner.host_s if inner else 0.0) / outer.calls
