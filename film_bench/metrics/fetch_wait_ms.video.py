"""Host ms in the program's `fi.fetch_wait` spans a new frame: the stream
blocked on a chunk's copy into pinned memory, over the traced new
frames."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.per_unit_ms(trace, 'fi.fetch_wait', ctx)
