"""Profiling helpers: torch.profiler traces, the port's spans, step timing.

Port of frame_interpolation_tpu/utils/profiling.py. The reference's only
performance observability is a steps/sec scalar; the train loop also
captures a trace of a window of steps (training/train_lib.py), here with
torch.profiler: the host's operators and, on a CUDA device, its kernels,
written as a Chrome trace (chrome://tracing, Perfetto).

`span(name)` marks where a layer's work begins and ends: the uploads,
replays and downloads of inference/interpolator.py and utils/programs.py,
the chunks and fetch waits of inference/recursion.py, the train step.
While a profiler runs, a span is a `record_function` range, so it lands in
the same trace as the kernels, copies and CUDA calls it launches, on their
clock; otherwise it is one shared null context, decided by one flag read.
The port's spans are named `fi.<what>`.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


_NO_SPAN = contextlib.nullcontext()
# Its `_is_profiler_enabled` says whether a profiler runs in the process:
# a flag of the process, not of the thread, so the sharded classes'
# threads read what the caller's thread reads.
_profiler_state = torch.autograd.profiler


def span(name: str):
  """A `record_function(name)` range while a profiler runs; otherwise the
  shared null context, after one flag read (on a CPU host a bare
  `record_function` costs about 16 us a use with nothing tracing, the
  read about 0.1 us). Open no span across a `yield`: the caller's time
  between items is not the port's."""
  if not _profiler_state._is_profiler_enabled:
    return _NO_SPAN
  return torch.profiler.record_function(name)


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
