"""Reduction of `torch.profiler` Chrome traces to what the per-layer readers
read: the device time of the kernels launched inside each named range and a
breakdown, from a stretch that records the host's ops (`summarize`); the
device's busy time and the span, from a stretch that records the device's
activity alone (`busy_span`), so that the profiler's cost on the host
hardly widens the span.

A range is a `torch.profiler.record_function` that the harness opens from
its own code around a call into the program (`bench.k1` around
`fused_mlp.fused_train`, `bench.k2` around `fused_mlp.fused_field_mlp_t`)
and around the whole profiled stretch (`bench.span`, which starts and ends
with the device idle). A device operation (kernel, memcpy, memset) belongs
to a range when the host call that launched it, found through the trace's
`correlation` id (else its `External id`), started inside the range. So a
kernel is attributed by where it was launched from, never by its name.

Without the host's ops the trace has no `bench.span`: its span runs from
the first host call into CUDA, or device operation, to the end of the last
one (the stretch ends in a synchronize).
"""

import bisect
import dataclasses
import json

SPAN = 'bench.span'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
HOST_CATS = ('cpu_op', 'user_annotation')
TOP = 10
NAME_CHARS = 120
MAX_WALK = 4096
IDLE_HOST = 'python between ops'


@dataclasses.dataclass
class Summary:
  """What a traced stretch showed. Times in seconds."""

  window_s: float  # The span's length on the trace's clock.
  busy_s: float  # The union of device operations within the span.
  device_s: float  # Their summed durations within the span.
  range_device_s: dict  # Range name -> device seconds launched inside it.
  range_calls: dict  # Range name -> how many times it was entered.
  device_ops: list  # [[name, seconds], ...], the most time first.
  idle_gaps: list  # [[host activity, seconds], ...], the most time first.


@dataclasses.dataclass
class Reading:
  """What a per-layer reader reads: the summary of the stretch that records
  the host's ops, the steps or calls it profiled, the busy time and span of
  the stretch that records the device alone, and the steps or calls of the
  untraced window with its length. Times in seconds."""

  summary: Summary
  units: int
  busy_s: float
  span_s: float
  window_units: int
  window_s: float


def _intervals(events):
  return sorted((e['ts'], e['ts'] + e.get('dur', 0)) for e in events)


def _union(intervals, lo, hi):
  """Total length of the union of `intervals` clipped to [lo, hi], and the
  gaps between them there, as (start, end) pairs."""
  total, gaps, at = 0.0, [], lo
  for start, end in intervals:
    start, end = max(start, lo), min(end, hi)
    if end <= start:
      continue
    if start > at:
      gaps.append((at, start))
    if end > at:
      total += end - max(start, at)
      at = end
  if hi > at:
    gaps.append((at, hi))
  return total, gaps


class _Ranges:
  """Intervals of the named host ranges, for 'was t inside one'."""

  def __init__(self, events):
    self.by_name = {}
    for e in events:
      self.by_name.setdefault(e['name'], []).append(
          (e['ts'], e['ts'] + e.get('dur', 0)))
    for spans in self.by_name.values():
      spans.sort()
    self.starts = {k: [s for s, _ in v] for k, v in self.by_name.items()}

  def containing(self, t, names):
    for name in names:
      spans = self.by_name.get(name, ())
      i = bisect.bisect_right(self.starts.get(name, ()), t) - 1
      if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return name
    return None


class _HostActivity:
  """What one host thread was doing at a time: its innermost op, else its
  innermost range, else plain Python between ops (`IDLE_HOST`)."""

  def __init__(self, events):
    ops = sorted(((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                  for e in events if e.get('cat') == 'cpu_op'),
                 key=lambda x: (x[0], -x[1]))
    self.ops, self.starts = ops, [s for s, _, _ in ops]
    self.ranges = sorted(((e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                          for e in events if e.get('cat') != 'cpu_op'
                          and e['name'] != SPAN), key=lambda x: -x[0])

  def at(self, t):
    i = bisect.bisect_right(self.starts, t) - 1
    for j in range(i, max(i - MAX_WALK, -1), -1):
      start, end, name = self.ops[j]
      if start <= t <= end:
        return name
    for start, end, name in self.ranges:
      if start <= t <= end:
        return name
    return IDLE_HOST


def summarize(trace, ranges):
  """The `Summary` of a Chrome trace (a dict) over its `bench.span`,
  attributing device time to the named `ranges`.

  Raises:
    ValueError: if the trace has no `bench.span` range, or more than one.
  """
  events = [e for e in trace.get('traceEvents', ())
            if e.get('ph') == 'X' and 'ts' in e]
  spans = [e for e in events if e.get('name') == SPAN
           and e.get('cat') in HOST_CATS]
  if len(spans) != 1:
    raise ValueError(f'The trace has {len(spans)} {SPAN} ranges; expected 1.')
  span = spans[0]
  lo, hi = span['ts'], span['ts'] + span['dur']
  host = [e for e in events if e.get('cat') in HOST_CATS]
  named = _Ranges([e for e in host if e['name'] in ranges])
  launches = {}
  for e in events:
    if e.get('cat') in LAUNCH_CATS and 'correlation' in e.get('args', {}):
      launches[e['args']['correlation']] = e['ts']
  by_external = {e['args']['External id']: e['ts'] for e in host
                 if 'External id' in e.get('args', {})}

  device = [e for e in events if e.get('cat') in DEVICE_CATS]
  in_span = []
  range_s = {name: 0.0 for name in ranges}
  op_s = {}
  for e in device:
    start, end = max(e['ts'], lo), min(e['ts'] + e.get('dur', 0), hi)
    if end <= start:
      continue
    seconds = (end - start) * 1e-6
    in_span.append(e)
    name = e['name'][:NAME_CHARS]
    op_s[name] = op_s.get(name, 0.0) + seconds
    args = e.get('args', {})
    launched = launches.get(args.get('correlation'))
    if launched is None:
      launched = by_external.get(args.get('External id'))
    owner = None if launched is None else named.containing(launched, ranges)
    if owner is not None:
      range_s[owner] += seconds
  busy, gaps = _union(_intervals(in_span), lo, hi)

  threads = {}
  for e in host:
    if lo <= e['ts'] <= hi:
      threads.setdefault(e.get('tid'), []).append(e)
  activity = _HostActivity(threads.get(span.get('tid'), ()))
  gap_s = {}
  for start, end in gaps:
    name = activity.at(0.5 * (start + end))[:NAME_CHARS]
    gap_s[name] = gap_s.get(name, 0.0) + (end - start) * 1e-6

  def top(d):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:TOP]

  return Summary(
      window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6,
      device_s=sum(op_s.values()), range_device_s=range_s,
      range_calls={name: len(named.by_name.get(name, ())) for name in ranges},
      device_ops=top(op_s), idle_gaps=top(gap_s))


def busy_span(trace):
  """(span, busy) seconds of a trace: its `bench.span` if it has one, else
  from the first host call into CUDA or device operation to the end of the
  last; busy is the union of device operations within it."""
  events = [e for e in trace.get('traceEvents', ())
            if e.get('ph') == 'X' and 'ts' in e]
  device = [e for e in events if e.get('cat') in DEVICE_CATS]
  spans = [e for e in events if e.get('name') == SPAN
           and e.get('cat') in HOST_CATS]
  if spans:
    lo, hi = spans[0]['ts'], spans[0]['ts'] + spans[0]['dur']
  else:
    edges = _intervals(e for e in events
                       if e.get('cat') in DEVICE_CATS + LAUNCH_CATS)
    if not edges:
      return 0.0, 0.0
    lo, hi = edges[0][0], max(end for _, end in edges)
  busy, _ = _union(_intervals(device), lo, hi)
  return (hi - lo) * 1e-6, busy * 1e-6


def summarize_file(path, ranges):
  with open(path) as f:
    return summarize(json.load(f), ranges)


def busy_span_file(path):
  with open(path) as f:
    return busy_span(json.load(f))
