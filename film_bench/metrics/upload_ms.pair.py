"""Host ms a traced request in the program's `fi.upload` spans: the
frames' and dt's crossings to the device (the pageable H2D, the launch of
the uint8 table lookup). Each span goes to the request whose span holds
its start; the mean over the traced requests."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.per_request_ms(trace, 'fi.upload')
