"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).

Copied from the port's measurement helpers so that the yardstick stays
with the benchmark.
"""
from __future__ import annotations

PEAK_FLOPS = {'bfloat16': 989e12, 'tf32': 495e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float, peak: float) -> float:
  """The least time: the larger of the FLOPs over `peak` and the bytes
  over HBM's rate."""
  return max(1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S)
