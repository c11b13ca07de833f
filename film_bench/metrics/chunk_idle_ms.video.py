"""Device idle ms a new frame that the stream's chunk work holds the
device back: each idle gap of the traced stretch (cut as the breakdown
cuts them, from the stretch's first device operation on) whose ending
operation was launched inside an `fi.chunk` span, by its launch on the
host's clock, over the traced new frames."""
from film_bench.metrics import _spans


def read(trace, outcome, ctx):
  return _spans.idle_launched_in_ms(trace, 'fi.chunk', ctx)
