"""Host milliseconds per training step in the trainer outside K1's call:
the program's `bnf.fit.step` spans less its `bnf.k1` spans (the draws, the
batch gather, the prior, VI's sample, log q and backward, Adam), from its
span table (`utils/profiling.span_table`) over both profiled stretches,
over the table's own count of `bnf.fit.step` steps. Read in a traced run
whose stretches ran on the device; nothing where the program keeps no
span table."""

from bayesnf_torch.utils import profiling


def read(reading, shapes):
  del shapes
  table = getattr(profiling, 'span_table', dict)()
  step = table.get('bnf.fit.step')
  if reading.busy_s <= 0 or step is None or step.calls <= 0:
    return None
  k1 = table.get('bnf.k1')
  return 1e3 * (step.host_s - (k1.host_s if k1 else 0.0)) / step.calls
