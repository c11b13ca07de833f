"""Device timing and roofline bounds for the port's measurement scripts.

`chip_smoke.py`, `tools/conv_sites.py` and `tools/profile_pair.py` take
their peaks, their timers, the idle share and their bounds from here, so that numbers from
the three can stand in one table. The port's library path never imports
this module. A copy of it, placed with the scripts in an unpacked older
checkout, measures that checkout the same way.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Tuple

import torch

# H100 SXM peaks (NVIDIA's data sheet, dense): tensor cores by input type,
# CUDA-core f32, and HBM3.
PEAK_FLOPS = {'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
# Device cycles (about 2.5 ms at 1.98 GHz) the card spins before a queued
# timed loop, so that the host queues the loop's launches while it waits.
QUEUE_CYCLES = 5_000_000


def card_line() -> str:
  """The card's name and power limit, as `nvidia-smi` gives them."""
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return query.stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], iters: int = 10,
            queued: bool = True) -> float:
  """Mean time of fn() over `iters` calls between two CUDA events, after
  one warm-up call.

  queued: the card spins QUEUE_CYCLES first, so the events time the
  device's work and not the host's launch cost (for a kernel of a few
  microseconds). Off, the host's lag between launches counts, as it does
  for a user: for end-to-end times.
  """
  fn()
  torch.cuda.synchronize()
  if queued:
    torch.cuda._sleep(QUEUE_CYCLES)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def busy_us(intervals) -> float:
  """Length of the union of (start, end) intervals."""
  total, reach = 0.0, float('-inf')
  for start, end in sorted(intervals):
    if end <= reach:
      continue
    total += end - max(start, reach)
    reach = end
  return total


def idle_share(fn: Callable[[], object], count: int = 5) -> dict:
  """fn() `count` times under torch.profiler, after one warm-up call: the
  host's wall ms a call (to a synchronize), the device's busy ms a call
  (the union of its kernels' intervals in the trace) and the idle share,
  1 - busy / wall; busy and idle are None where the trace holds no
  kernel."""
  fn()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(count):
      fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start) / count
  with tempfile.TemporaryDirectory() as work:
    path = os.path.join(work, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  kernels = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('cat') == 'kernel' and 'dur' in e]
  busy_ms = busy_us(kernels) / 1e3 / count if kernels else None
  return {'wall_ms': wall_ms, 'busy_ms': busy_ms,
          'kernels': len(kernels) / count,
          'idle': None if busy_ms is None else 1.0 - busy_ms / wall_ms}


def roofline(flops: float, nbytes: float, peak: float) -> dict:
  """bound_ms: the larger of the FLOPs over `peak` and the compulsory bytes
  (each input read once, each output written once) over HBM's rate."""
  ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S
  return {'bound_ms': max(ops_ms, bytes_ms), 'bound_ops_ms': ops_ms,
          'bound_bytes_ms': bytes_ms,
          'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes'}


def conv_cost(n: int, h: int, w: int, cin: int, cout: int, pool: bool,
              element_size: int) -> Tuple[float, float]:
  """FLOPs and compulsory bytes of one conv3x3 + bias + leaky (+ 2x2 pool)
  site: x and the weights read in x's dtype, the f32 bias, y and the pool
  written in x's dtype."""
  pixels = n * h * w
  flops = 2.0 * pixels * 9 * cin * cout
  nbytes = (pixels * (cin + cout) * element_size +
            9 * cin * cout * element_size + cout * 4 +
            (pixels // 4 * cout * element_size if pool else 0))
  return flops, nbytes


def bilinear_grid(flow: torch.Tensor, row_shift: int = 0,
                  source_h: int = None) -> torch.Tensor:
  """The (B, H, W, 2) grid under which `F.grid_sample` (bilinear, border
  padding, align_corners=True) computes the port's warp of a (B, H, W, 2)
  flow, and the image gradient of its backward the warp's splat.

  The warp clamps the floor of each coordinate to [0, size-2] and its alpha
  to [0, 1]; border padding clamps the coordinate to [0, size-1]. Both give
  the same corner weights. For the row mode's yardstick, `row_shift`
  (row_offset - src_row0) moves the rows into a source of `source_h` rows
  (border padding then clamps to that source's rows, not the frame's).
  """
  _, h, w, _ = flow.shape
  source_h = h if source_h is None else source_h
  ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                          torch.arange(w, device=flow.device), indexing='ij')
  return torch.stack([(xs + flow[..., 0]) * (2.0 / (w - 1)) - 1,
                      (ys + row_shift + flow[..., 1]) * (2.0 / (source_h - 1))
                      - 1], dim=-1)
