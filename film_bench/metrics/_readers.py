"""Helpers of the per-layer readers (film_bench/metrics/<metric>.py).

A reader is `read(trace, outcome, ctx) -> float or None`: `trace` the
traced stretch (film_bench/trace.py), `outcome` what the entry's window
returned, `ctx` the run's context (configuration, workload). None means
there is nothing to read in this run, and the metric is left out.
"""
from __future__ import annotations

from film_bench import trace as trace_lib
from film_bench.costs import peaks


def matches(name: str, kernels) -> bool:
  """Whether a device operation is one of `kernels` (function names)."""
  return trace_lib.base_name(name) in kernels


def idle_percent(trace) -> float:
  return 100.0 * (1.0 - trace.busy_us() / trace.window_us)


def mfu_percent(flops: float, seconds: float, ctx) -> float:
  return 100.0 * flops / seconds / peaks.PEAK_FLOPS[ctx.config['mfu_peak']]
