"""Device busy ms (every kernel, copy and set) of the traced stretch over
the new frames handed to the host in it."""


def read(trace, outcome, ctx):
  if not ctx.traced_units:
    return None
  return trace.busy_us() / 1e3 / ctx.traced_units
