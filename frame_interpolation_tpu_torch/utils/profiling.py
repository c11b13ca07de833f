"""Profiling helpers: torch.profiler traces and step timing.

Port of frame_interpolation_tpu/utils/profiling.py. The reference's only
performance observability is a steps/sec scalar; the train loop also
captures a trace of a window of steps (training/train_lib.py), here with
torch.profiler: the host's operators and, on a CUDA device, its kernels,
written as a Chrome trace (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _activities():
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  return activities


class Trace:
  """A torch.profiler trace, started on construction, written by stop()."""

  def __init__(self, logdir: str):
    self._logdir = logdir
    self._profiler = torch.profiler.profile(activities=_activities())
    self._profiler.start()

  def stop(self, name: str = 'trace') -> str:
    """Ends the trace once the device's queued work is done and writes it
    to `<logdir>/<name>.json`; returns that path."""
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    self._profiler.stop()
    os.makedirs(self._logdir, exist_ok=True)
    path = os.path.join(self._logdir, f'{name}.json')
    self._profiler.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_if(logdir: Optional[str]) -> Iterator[None]:
  """A trace of the block into `<logdir>/trace.json` when `logdir` is set;
  no-op otherwise."""
  if not logdir:
    yield
    return
  trace = Trace(logdir)
  try:
    yield
  finally:
    trace.stop()


class StepTimer:
  """Steps/sec over a sliding interval (SecondOrStepTimer parity).

  `start_step` is the step the clock starts at (a resumed run's). With a
  CUDA `device`, the rate waits for the device's queued work, so it counts
  the steps that ran rather than the steps that were launched.
  """

  def __init__(self, interval: int = 100, start_step: int = 0,
               device: Optional[torch.device] = None):
    self.interval = interval
    self._device = device
    self._last_time = time.monotonic()
    self._last_step = start_step

  def update(self, step: int) -> Optional[float]:
    """Returns steps/sec when `interval` steps elapsed, else None."""
    if step - self._last_step < self.interval:
      return None
    if self._device is not None and self._device.type == 'cuda':
      torch.cuda.synchronize(self._device)
    now = time.monotonic()
    rate = (step - self._last_step) / max(now - self._last_time, 1e-9)
    self._last_time = now
    self._last_step = step
    return rate
