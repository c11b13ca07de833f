"""Median ms of the traced run's requests outside its traced stretch
(host clock, as pair_ms_p95): a shifted median or a fatter tail."""
import numpy as np


def read(trace, outcome, ctx):
  latencies = outcome.get('untraced_ms')
  return float(np.median(latencies)) if latencies else None
