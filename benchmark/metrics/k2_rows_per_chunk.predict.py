"""The rows each of K2's inner row chunks carries, the M of its per-member
GEMMs: a predict call's grid rows padded to whole forward chunks, over the
call's K2 row chunks under the scratch budget (the program's counter
`bnf.k2.row_chunks`, summed over both profiled stretches, over the span
table's count of `bnf.predict` calls). Read in a traced run whose
stretches ran on the device; nothing where the program keeps no such
counter."""

from bayesnf_torch.utils import profiling

FORWARD_CHUNK = 4096  # The predict's forward chunk (`k2_chunk_rows`).


def read(reading, shapes):
  table = getattr(profiling, 'span_table', dict)()
  outer = table.get('bnf.predict')
  chunks = getattr(profiling, 'counters', dict)().get('bnf.k2.row_chunks', 0)
  if reading.busy_s <= 0 or outer is None or outer.calls <= 0 or chunks <= 0:
    return None
  padded = -(-shapes['rows'] // FORWARD_CHUNK) * FORWARD_CHUNK
  return padded * outer.calls / chunks
