"""The whole request's share of the card's peak, in percent: the pair's
model FLOPs (costs/film_net.py, from shapes) over the median untraced request's
wall time, against the configuration's peak (bf16: 989 TFLOP/s)."""
import numpy as np

from film_bench.metrics._readers import mfu_percent


def read(trace, outcome, ctx):
  latencies = outcome.get('untraced_ms')
  if not latencies:
    return None
  return mfu_percent(outcome['flops_per_unit'],
                     float(np.median(latencies)) / 1e3, ctx)
