"""The traced part of a run: a torch.profiler trace of a stretch of the
window, read back into device operations, host operations and the
benchmark's own spans.

The benchmark marks its units of work with `record_function` spans named
`film_bench.<unit>` (a request, a step) and the traced stretch with
`film_bench.window`, so every reader works in the trace's own clock.
Device operations are the trace's kernels, copies and sets; the device is
busy over the union of their intervals. A device operation belongs to the
unit whose span holds the host call that launched it (the trace links the
two by a correlation id), so the offset between the device's clock and
the host's, which can reach milliseconds, moves no operation into another
unit.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation',
             'python_function')
PREFIX = 'film_bench.'


class Event(NamedTuple):
  name: str
  start: float  # us, the trace's clock
  dur: float
  launched: Optional[float] = None  # the launching host call's start

  @property
  def end(self) -> float:
    return self.start + self.dur

  @property
  def issued(self) -> float:
    """When the host launched it, where the trace says; else its start."""
    return self.start if self.launched is None else self.launched


def base_name(kernel: str) -> str:
  """A kernel's function name without its return type, namespaces,
  template arguments and parameters: 'void (anonymous
  namespace)::conv3x3_wgmma_kernel<...>(...)' -> 'conv3x3_wgmma_kernel'."""
  name = kernel.replace('(anonymous namespace)::', '')
  name = name[5:] if name.startswith('void ') else name
  cut = re.search(r'[<(]', name)
  name = name[:cut.start()] if cut else name
  return name.split('::')[-1].strip()


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
  """Length of the union of (start, end) intervals."""
  total, reach = 0.0, float('-inf')
  for start, end in sorted(intervals):
    if end <= reach:
      continue
    total += end - max(start, reach)
    reach = end
  return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                   float]]:
  out: List[List[float]] = []
  for start, end in sorted(intervals):
    if out and start <= out[-1][1]:
      out[-1][1] = max(out[-1][1], end)
    else:
      out.append([start, end])
  return [(a, b) for a, b in out]


class Trace:
  """A read trace: device operations, host operations and spans."""

  def __init__(self, events: Sequence[dict]):
    self.device: List[Event] = []
    self._kernels: List[Event] = []
    self.host: List[Event] = []
    self.spans: List[Event] = []
    calls = {e['args']['correlation']: float(e['ts']) for e in events
             if e.get('cat') in ('cuda_runtime', 'cuda_driver') and
             'correlation' in e.get('args', {})}
    for e in events:
      if e.get('ph') != 'X' or 'dur' not in e:
        continue
      event = Event(e.get('name', ''), float(e['ts']), float(e['dur']))
      cat = e.get('cat', '')
      if cat in DEVICE_CATS:
        event = event._replace(
            launched=calls.get(e.get('args', {}).get('correlation')))
        self.device.append(event)
        if cat == 'kernel':
          self._kernels.append(event)
      elif cat == 'user_annotation' and event.name.startswith(PREFIX):
        self.spans.append(event)
      elif cat in HOST_CATS:
        self.host.append(event)
    self.device.sort(key=lambda e: e.start)
    self._kernels.sort(key=lambda e: e.start)
    self._issued = {
        only: sorted(self._kernels if only else self.device,
                     key=lambda e: e.issued) for only in (False, True)}
    self.host.sort(key=lambda e: e.start)
    windows = self.named('window')
    if windows:
      self.start, self.end = windows[0].start, windows[-1].end
    elif self.device:
      self.start = self.device[0].start
      self.end = max(e.end for e in self.device)
    else:
      self.start = self.end = 0.0

  @classmethod
  def from_profiler(cls, profiler) -> 'Trace':
    """Exports the profiler's trace to a temporary file and reads it."""
    handle, path = tempfile.mkstemp(suffix='.json')
    os.close(handle)
    try:
      profiler.export_chrome_trace(path)
      with open(path) as f:
        events = json.load(f)['traceEvents']
    finally:
      os.remove(path)
    return cls(events)

  def named(self, unit: str) -> List[Event]:
    return [e for e in self.spans if e.name == PREFIX + unit]

  @property
  def window_us(self) -> float:
    return self.end - self.start

  def device_in(self, start: float, end: float,
                kernels_only: bool = False) -> List[Event]:
    """Device operations launched inside [start, end) (`Event.issued`)."""
    ops = self._issued[kernels_only]
    issued = [e.issued for e in ops]
    return ops[bisect.bisect_left(issued, start):
               bisect.bisect_left(issued, end)]

  def kernels(self) -> List[Event]:
    return self._kernels

  def busy_us(self, start: Optional[float] = None, end: Optional[float] = None,
              kernels_only: bool = False) -> float:
    """The union of device operations, clipped to [start, end)."""
    start = self.start if start is None else start
    end = self.end if end is None else end
    ops = self.kernels() if kernels_only else self.device
    return union_us((max(e.start, start), min(e.end, end)) for e in ops
                    if e.end > start and e.start < end)

  def time_by_name(self, ops: Iterable[Event]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in ops:
      key = base_name(e.name)
      out[key] = out.get(key, 0.0) + e.dur
    return out

  def breakdown(self, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the window and the
    idle time of the device by the host operation running when each gap
    began (the innermost one), in seconds."""
    inside = [e for e in self.device
              if e.start >= self.start and e.start < self.end]
    ops = sorted(self.time_by_name(inside).items(), key=lambda kv: -kv[1])
    busy = merged((max(e.start, self.start), min(e.end, self.end))
                  for e in inside)
    edges = [self.start] + [b for _, b in busy]
    nexts = [a for a, _ in busy] + [self.end]
    gaps: Dict[str, float] = {}
    host = [e for e in self.host if e.end > self.start and
            e.start < self.end]
    starts = [e.start for e in host]
    for gap_start, gap_end in zip(edges, nexts):
      if gap_end <= gap_start:
        continue
      name = 'no host operation'
      i = bisect.bisect_right(starts, gap_start)
      # The latest-starting host operation that spans the gap's start.
      for e in reversed(host[max(0, i - 64):i]):
        if e.end >= gap_start:
          name = e.name
          break
      gaps[name] = gaps.get(name, 0.0) + (gap_end - gap_start)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {'device_ops': [[n[:160], t / 1e6] for n, t in ops[:top]],
            'idle_gaps': [[n[:160], t / 1e6] for n, t in idle[:top]]}
