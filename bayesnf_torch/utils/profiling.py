"""Profiling hooks: trace capture and throughput counters (counterpart of
`bayesnf_tpu/utils/profiling.py`).

Any block can drop a `torch.profiler` Chrome trace (`maybe_trace`) and
report member-steps/s/chip (`StepTimer`), the port's headline throughput
metric. CUDA runs asynchronously, so `StepTimer` synchronizes the card
before it reads the clock.
"""

import contextlib
import dataclasses
import os
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
