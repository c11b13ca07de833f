"""Host ms a request beyond the device's: each traced request's span
less the union of the kernels it launched (the uint8 upload, the pageable
download, numpy, the graph's launch), the mean over the traced requests."""
from film_bench import trace as trace_lib


def read(trace, outcome, ctx):
  spans = trace.named('request')
  if not spans:
    return None
  host = []
  for s in spans:
    kernels = trace.device_in(s.start, s.end, kernels_only=True)
    host.append(s.dur - trace_lib.union_us((e.start, e.end) for e in kernels))
  return sum(host) / len(host) / 1e3
