"""Profiling hooks: trace capture and throughput counters (counterpart of
`bayesnf_tpu/utils/profiling.py`).

Any block can drop a `torch.profiler` Chrome trace (`maybe_trace`) and
report member-steps/s/chip (`StepTimer`), the port's headline throughput
metric. CUDA runs asynchronously, so `StepTimer` synchronizes the card
before it reads the clock. `device_kind` and `num_devices` label the CLI
tools' artifacts with the card a run used.
"""

import contextlib
import dataclasses
import os
import subprocess
import time

import torch
import torch.profiler


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
