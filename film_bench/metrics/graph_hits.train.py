"""The share of the train step's calls in the traced stretch that replayed
its captured graph: 100 x `fi.replay.*` spans / (`fi.replay.*` +
`fi.capture.*` spans). Below 100, a step was captured in the window."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.graph_hits(trace)
