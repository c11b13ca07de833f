"""Host ms in the program's `fi.chunk` spans a new frame: the stream's
work to issue a chunk (stacking its frames, the upload, the features and
tree replays, the fetch's issue), over the traced new frames."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.per_unit_ms(trace, 'fi.chunk', ctx)
