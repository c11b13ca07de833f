"""Helpers of the readers of the program's own spans.

The port marks where its layers' work begins and ends with `fi.<what>`
spans (frame_interpolation_tpu_torch/utils/profiling.span): the request's
`fi.upload` and `fi.download`, the programs' `fi.replay.<program>` and
`fi.capture.<program>`, the stream's `fi.chunk` and `fi.fetch_wait`. They
land in the trace as host annotations beside the kernels they launch, on
the same clock, and the trace files them under `Trace.host`. A program
that marks nothing (one older than its spans) leaves each reader here
with nothing to read: None, not 0.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

PREFIX = 'fi.'


def marked(trace) -> bool:
  """Whether the traced program marked any of its spans."""
  return any(e.name.startswith(PREFIX) for e in trace.host)


def spans(trace, name: str) -> list:
  """The program's spans named `name`, in start order."""
  return [e for e in trace.host if e.name == name]


def per_request_ms(trace, name: str) -> Optional[float]:
  """Host ms in `name` spans a traced request: each span goes to the
  request whose span holds its start; the mean over the requests."""
  requests = trace.named('request')
  if not requests or not marked(trace):
    return None
  starts = [r.start for r in requests]
  total = 0.0
  for e in spans(trace, name):
    i = bisect.bisect_right(starts, e.start) - 1
    if i >= 0 and e.start < requests[i].end:
      total += e.dur
  return total / len(requests) / 1e3


def per_unit_ms(trace, name: str, ctx) -> Optional[float]:
  """Host ms in `name` spans, clipped to the traced stretch, over the
  units of work handed over in it (a video's new frames)."""
  if not ctx.traced_units or not marked(trace):
    return None
  total = sum(max(0.0, min(e.end, trace.end) - max(e.start, trace.start))
              for e in spans(trace, name))
  return total / ctx.traced_units / 1e3


def graph_hits(trace) -> Optional[float]:
  """100 x replays / (replays + captures) of the programs in the traced
  stretch."""
  if not marked(trace):
    return None
  replays = captures = 0
  for e in trace.host:
    if trace.start <= e.start < trace.end:
      replays += e.name.startswith(PREFIX + 'replay.')
      captures += e.name.startswith(PREFIX + 'capture.')
  if not replays + captures:
    return None
  return 100.0 * replays / (replays + captures)


def idle_gaps(trace) -> List[Tuple[float, float, object]]:
  """(start, end, the device operation that ends it) of each of the
  device's idle gaps in the traced stretch, cut as `Trace.breakdown` cuts
  them: between the union of the operations that start in the stretch.
  Two gaps are left out: the one before the stretch's end, which no
  operation ends, and the one before its first operation, since the
  device may still be running work launched before the trace began,
  which the trace does not record (on an H100, up to 0.35 s of a video
  chunk's queued work)."""
  out = []
  reach = None
  for e in trace.device:  # in start order
    if e.start < trace.start or e.start >= trace.end:
      continue
    if reach is not None and e.start > reach:
      out.append((reach, e.start, e))
    reach = max(e.start if reach is None else reach, min(e.end, trace.end))
  return out


def idle_launched_in_ms(trace, name: str, ctx) -> Optional[float]:
  """Device idle ms over the traced units, counting each gap whose ending
  operation was launched (`Event.issued`, the host's clock) inside a
  `name` span: the device waited on what the host did there."""
  if not ctx.traced_units or not marked(trace):
    return None
  marks = sorted((e.start, e.end) for e in spans(trace, name))
  starts = [s for s, _ in marks]
  idle = 0.0
  for gap_start, gap_end, op in idle_gaps(trace):
    i = bisect.bisect_right(starts, op.issued) - 1
    if i >= 0 and op.issued < marks[i][1]:
      idle += gap_end - gap_start
  return idle / ctx.traced_units / 1e3
