"""The device's idle share of the traced stretch, in percent: 1 - busy /
wall, busy the union of every kernel, copy and set."""
from film_bench.metrics._readers import idle_percent


def read(trace, outcome, ctx):
  return idle_percent(trace) if trace.window_us > 0 else None
