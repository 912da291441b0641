"""Profiling hooks: trace capture, the program's spans and counters, and
throughput counters (counterpart of `bayesnf_tpu/utils/profiling.py`).

Any block can drop a `torch.profiler` Chrome trace (`maybe_trace`) and
report member-steps/s/chip (`StepTimer`), the port's headline throughput
metric. CUDA runs asynchronously, so `StepTimer` synchronizes the card
before it reads the clock. `device_kind` and `num_devices` label the CLI
tools' artifacts with the card a run used.

The estimator, the predict, the root-find, the trainers and the kernels'
entries mark their layers with `span('bnf.<layer>')`. A span records only
while a `torch.profiler` records; otherwise it costs one flag check and a
shared no-op context. Recording, it opens a `record_function` range of its
name, so the span lands in the profiler's trace on the kernels' clock, and
adds its calls, host seconds and self seconds (less its child spans) to a
table in memory (`span_table`). `count` adds to named counters
(`counters`), which may be device tensors, read once at the end.
`reset` empties both.
"""

import contextlib
import dataclasses
import os
import subprocess
import threading
import time

import torch
import torch.autograd.profiler as autograd_profiler
import torch.profiler

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_OPEN = threading.local()  # Each thread's stack of open spans.


@dataclasses.dataclass
class SpanStats:
  """What the spans of one name recorded: calls, host seconds from entry to
  exit, and the part of those that no child span covers."""

  calls: int = 0
  host_s: float = 0.0
  self_s: float = 0.0


_SPANS: dict[str, SpanStats] = {}
_COUNTERS: dict = {}


def recording() -> bool:
  """Whether a `torch.profiler` (or `torch.autograd.profiler`) records."""
  return autograd_profiler._is_profiler_enabled  # pylint: disable=protected-access


class _Span:
  """One recording span: its `record_function` range and its clock."""

  __slots__ = ('name', 'range', 'start', 'children')

  def __init__(self, name):
    self.name = name

  def __enter__(self):
    stack = getattr(_OPEN, 'stack', None)
    if stack is None:
      stack = _OPEN.stack = []
    stack.append(self)
    self.children = 0.0
    self.range = torch.profiler.record_function(self.name)
    self.range.__enter__()
    self.start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    host = time.perf_counter() - self.start
    self.range.__exit__(*exc)
    stack = _OPEN.stack
    stack.pop()
    if stack:
      stack[-1].children += host
    with _LOCK:
      stats = _SPANS.setdefault(self.name, SpanStats())
      stats.calls += 1
      stats.host_s += host
      stats.self_s += host - self.children
    return False


def span(name: str):
  """A context for the layer `name` (`bnf.` and the layer): a
  `record_function` range and a row of `span_table` while a profiler
  records, else a no-op."""
  if not autograd_profiler._is_profiler_enabled:  # pylint: disable=protected-access
    return _OFF
  return _Span(name)


def span_table() -> dict[str, SpanStats]:
  """A copy of the spans' table: name -> `SpanStats`."""
  with _LOCK:
    return {k: dataclasses.replace(v) for k, v in _SPANS.items()}


def count(name: str, value):
  """Adds `value` (an int, or a 0-d tensor left on its device) to the
  counter `name`."""
  with _LOCK:
    total = _COUNTERS.get(name, 0)
    if isinstance(total, torch.Tensor) and isinstance(value, torch.Tensor):
      value = value.to(total.device)
    _COUNTERS[name] = total + value


def counters() -> dict[str, int]:
  """The counters as ints (a device counter synchronizes here, once)."""
  with _LOCK:
    return {k: int(v) for k, v in _COUNTERS.items()}


def reset():
  """Empties the spans' table and the counters."""
  with _LOCK:
    _SPANS.clear()
    _COUNTERS.clear()


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
  """Trace the block with `torch.profiler` (the CPU, and CUDA when it is
  available) and write a Chrome trace into `trace_dir`, when it is set."""
  if not trace_dir:
    yield
    return
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(trace_dir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield
  prof.export_chrome_trace(os.path.join(
      trace_dir, f'trace.{os.getpid()}.{time.time_ns()}.json'))


@dataclasses.dataclass
class ThroughputReport:
  """Throughput of one training call."""

  member_steps: int
  seconds: float
  num_chips: int

  @property
  def member_steps_per_sec_per_chip(self) -> float:
    return self.member_steps / self.seconds / max(self.num_chips, 1)

  def __str__(self):
    return (
        f'{self.member_steps} member-steps in {self.seconds:.2f}s on '
        f'{self.num_chips} chip(s) = '
        f'{self.member_steps_per_sec_per_chip:.1f} member-steps/s/chip'
    )


def _pci_address(bus_id):
  """(domain, bus, device) of nvidia-smi's "00000000:19:00.0", or None
  where it prints no address ("[N/A]")."""
  try:
    domain, bus, rest = bus_id.split(':')
    return int(domain, 16), int(bus, 16), int(rest.split('.')[0], 16)
  except ValueError:
    return None


def device_kind(device) -> str:
  """The card's name and power limit as `nvidia-smi --query-gpu=name,
  power.limit --format=csv,noheader` prints them for a CUDA `device`, else
  'cpu'.

  nvidia-smi lists every card of the host whatever CUDA_VISIBLE_DEVICES
  hides or reorders, so the line is the one with the device's PCI address
  or UUID. Where nvidia-smi reads neither (a virtual machine may hide
  both), it is the line of the card that CUDA_VISIBLE_DEVICES puts at the
  device's index.
  """
  device = torch.device(device)
  if device.type != 'cuda':
    return 'cpu'
  index = device.index or 0
  props = torch.cuda.get_device_properties(index)
  pci = (props.pci_domain_id, props.pci_bus_id, props.pci_device_id)
  uuid = f'GPU-{props.uuid}'
  visible = os.environ.get('CUDA_VISIBLE_DEVICES')
  physical = (str(index) if visible is None
              else visible.split(',')[index].strip())
  rows = [[field.strip() for field in line.split(',')]
          for line in subprocess.run(
              ['nvidia-smi',
               '--query-gpu=index,uuid,pci.bus_id,name,power.limit',
               '--format=csv,noheader'],
              check=True, capture_output=True,
              text=True).stdout.strip().splitlines()]
  for by in (lambda row: _pci_address(row[2]) == pci,
             lambda row: row[1] == uuid,
             lambda row: physical in (row[0], row[1])):
    for row in rows:
      if by(row):
        return f'{row[3]}, {row[4]}'
  raise RuntimeError(f'nvidia-smi lists no card with cuda:{index}\'s PCI '
                     f'address {pci}, UUID or CUDA_VISIBLE_DEVICES entry '
                     f'{physical!r}.')


def num_devices(device) -> int:
  """The devices of `device`'s type: the CUDA cards, or 1 (the CPU)."""
  if torch.device(device).type == 'cuda':
    return torch.cuda.device_count()
  return 1


def _synchronize():
  if torch.cuda.is_initialized():
    torch.cuda.synchronize()


class StepTimer:
  """Times a block and converts it to a ThroughputReport.

  The card is synchronized on entry and on exit (when CUDA is initialized),
  so the time covers the work the block queued, not just its launches.

  Example:
    with StepTimer(member_steps=epochs * batches * ensemble) as t:
      losses = train(...)
    print(t.report)
  """

  def __init__(self, member_steps: int, num_chips: int | None = None):
    self.member_steps = member_steps
    self.num_chips = num_chips or torch.cuda.device_count() or 1
    self.report = None

  def __enter__(self):
    _synchronize()
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    _synchronize()
    self.report = ThroughputReport(
        member_steps=self.member_steps,
        seconds=time.perf_counter() - self._start,
        num_chips=self.num_chips,
    )
    return False
