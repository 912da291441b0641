"""Host milliseconds per predict call in the encode: the program's
`bnf.predict.encode` spans (each forward chunk's `encode_t_groups`, inside
`bnf.predict.forward`), from its span table (`utils/profiling.span_table`)
over both profiled stretches, over the table's own count of `bnf.predict`
calls. Read in a traced run whose stretches ran on the device; nothing
where the program records no such span."""

from bayesnf_torch.utils import profiling


def read(reading, shapes):
  del shapes
  table = getattr(profiling, 'span_table', dict)()
  outer = table.get('bnf.predict')
  inner = table.get('bnf.predict.encode')
  if reading.busy_s <= 0 or outer is None or outer.calls <= 0 or not inner:
    return None
  return 1e3 * inner.host_s / outer.calls
