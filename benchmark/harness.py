"""One run of one cell: set-up, the measured window (traced, followed by two
profiled stretches), the device's peak memory, then the check against the
plain reference and of the program's kernel launches, reduced to the result
line.

The traced run's first stretch records the host's ops and the device's,
with the program's K1 and K2 entries (`fused_mlp.fused_train`,
`fused_mlp.fused_field_mlp_t`) wrapped in profiler ranges of this file
(`bench.k1`, `bench.k2`) and the stretch in `bench.span`; its second
records the device alone. `tracing` reduces both, and each per-layer
metric's reader (`metrics/<name>.py`) reads them with the untraced window's
steps or calls and length (`tracing.Reading`).
"""

import contextlib
import os
import pathlib
import sys
import time

from bayesnf_torch.ops import fused_mlp
import torch
import torch.profiler

from benchmark import checks
from benchmark import loads
from benchmark import tracing

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'bayesnf_tpu')
RANGES = {'bench.k1': 'fused_train', 'bench.k2': 'fused_field_mlp_t'}
COUNTERS = ('launches', 'bwd_launches', 'bf16_launches')


def forbidden_modules():
  """Loaded modules whose top-level name is one of FORBIDDEN."""
  return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def entry_ranges(names):
  """The program's entries of the ranges `names` wrapped in them; each
  wrapper carries the entry's launch counters, which the entry counts on
  under its module name, and hands them back when it is taken out."""
  saved = {}
  for name in names:
    attr = RANGES[name]
    original = getattr(fused_mlp, attr)

    def wrapper(*args, _original=original, _name=name, **kwargs):
      with torch.profiler.record_function(_name):
        return _original(*args, **kwargs)

    for counter in COUNTERS:
      if hasattr(original, counter):
        setattr(wrapper, counter, getattr(original, counter))
    saved[attr] = (original, wrapper)
    setattr(fused_mlp, attr, wrapper)
  try:
    yield
  finally:
    for attr, (original, wrapper) in saved.items():
      for counter in COUNTERS:
        if hasattr(wrapper, counter):
          setattr(original, counter, getattr(wrapper, counter))
      setattr(fused_mlp, attr, original)


def profile_stretch(load, trace_path, host):
  """The load's stretch under torch.profiler, recording the host's ops and
  the named ranges (`host`) or the device's activity alone; the path of its
  Chrome trace and the units of work (steps or calls) it profiled."""
  cuda = load.device.type == 'cuda'
  activities = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
  if host or not cuda:
    activities.append(torch.profiler.ProfilerActivity.CPU)
  holder = {}

  @contextlib.contextmanager
  def profiled():
    with entry_ranges(load.ranges if host else ()):
      loads.sync(load.device)
      with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(tracing.SPAN):
          yield
          loads.sync(load.device)
      holder['prof'] = prof

  units = load.stretch(profiled)
  trace_path = pathlib.Path(trace_path)
  trace_path.parent.mkdir(parents=True, exist_ok=True)
  holder['prof'].export_chrome_trace(str(trace_path))
  return trace_path, units


def traced(load, window, workload, out_dir):
  """The `tracing.Reading` of the two profiled stretches after `window`
  (the untraced window's {'units', 'seconds'}), and the gap between each
  range's entries and the launches the stretch's work asks for."""
  path, units = profile_stretch(
      load, os.path.join(out_dir, 'trace', f'{workload}.json'), host=True)
  summary = tracing.summarize_file(path, load.ranges)
  path, _ = profile_stretch(
      load, os.path.join(out_dir, 'trace', f'{workload}.device.json'),
      host=False)
  span_s, busy_s = tracing.busy_span_file(path)
  if load.device.type == 'cuda' and not busy_s:
    raise RuntimeError('The device-only trace holds no device operation.')
  gap = max((abs(calls - load.expected_launches(units))
             for calls in summary.range_calls.values()), default=0)
  reading = tracing.Reading(
      summary=summary, units=units,
      busy_s=busy_s, span_s=span_s, window_units=window['units'],
      window_s=window['seconds'])
  return reading, gap


def device_info(device):
  if device.type != 'cuda':
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': 0}
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
          'count': 1,
          'memory_peak_bytes': int(torch.cuda.max_memory_allocated(device))}


def run(bench, workload, seed, seconds, trace, started, device='cuda',
        backend=None, out_dir='.benchrun'):
  """(result line, info line) of one run of `workload`; `started` is the
  `time.monotonic()` at which the process started."""
  cell = bench.workload(workload)
  cfg = bench.config(cell['config'])
  traffic = bench.traffic(cell['traffic'])
  load = loads.make(cfg, traffic, seed, device, backend or cfg['backend'],
                    bench.table(cfg['table']['generator']),
                    bench.reference(cfg['reference']))
  load.setup()
  setup_s = time.monotonic() - started
  metrics, extra = {}, {}
  measured = dict(load.window(seconds), setup_s=setup_s)
  info = dict(load.info)
  if trace:
    reading, range_gap = traced(
        load, {'units': load.attempted, 'seconds': info['window_s']},
        workload, out_dir)
    load.launch_gap = max(load.launch_gap, range_gap)
    for m in bench.per_layer(workload):
      value = bench.reader(m['name']).read(reading, load.shapes)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    summary = reading.summary
    extra['breakdown'] = {'device_ops': summary.device_ops,
                          'idle_gaps': summary.idle_gaps}
    info.update(profiled_units=reading.units,
                range_calls=summary.range_calls,
                range_device_s=summary.range_device_s,
                device_s=summary.device_s, host_trace_s=summary.window_s,
                host_trace_busy_s=summary.busy_s)
  else:
    for m in bench.end_to_end(workload):
      metrics[m['name']] = {'value': measured[m['name']], 'unit': m['unit']}
  dev = device_info(load.device)
  if trace:
    dev.update(busy_s=reading.busy_s, window_s=reading.span_s)
  load.release()
  tic = time.monotonic()
  numbers = load.check()
  info['check_s'] = time.monotonic() - tic
  correct, table = checks.judge(numbers, bench.limits(workload))
  # The program's kernels ran as often as the work asks for: exactly.
  table[load.launch_check] = {'value': load.launch_gap, 'limit': 0}
  correct = correct and load.launch_gap == 0
  result = {'correct': correct and load.failed == 0,
            'attempted': load.attempted, 'failed': load.failed,
            'metrics': metrics, 'device': dev, **extra, 'checks': table}
  info.update(workload=workload, seed=seed, setup_s=setup_s)
  return result, info
