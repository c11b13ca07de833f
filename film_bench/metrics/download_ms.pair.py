"""Host ms a traced request in the program's `fi.download` spans: the
result's pageable D2H and its numpy view, once the device has finished
it. Each span goes to the request whose span holds its start; the mean
over the traced requests."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.per_request_ms(trace, 'fi.download')
