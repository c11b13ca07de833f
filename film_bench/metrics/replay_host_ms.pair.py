"""Host ms a traced request in the program's `fi.replay.pair` spans: the
copies into the pair graph's static buffers, its launch and the output's
clone. Each span goes to the request whose span holds its start; the mean
over the traced requests."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.per_request_ms(trace, 'fi.replay.pair')
