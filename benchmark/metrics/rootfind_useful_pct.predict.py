"""The share of the mixture quantiles' search iterations that any lane
needed: 100 x the program's counter `bnf.rootfind.iterations_needed` (for
each search, the iterations until every lane had converged) over
`bnf.rootfind.iterations_run`, both counted on the device over both
profiled stretches (`utils/profiling.counters`). Read in a traced run whose
stretches ran on the device; nothing where the program keeps no
counters."""

from bayesnf_torch.utils import profiling


def read(reading, shapes):
  del shapes
  counts = getattr(profiling, 'counters', dict)()
  run = counts.get('bnf.rootfind.iterations_run', 0)
  if reading.busy_s <= 0 or run <= 0:
    return None
  return 100 * counts.get('bnf.rootfind.iterations_needed', 0) / run
