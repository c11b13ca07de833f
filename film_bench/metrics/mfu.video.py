"""The tree's share of the card's peak, in percent: per new frame, a
midpoint's FLOPs plus the clip's extractions spread over its new frames
(each input frame and each new frame that is not a leaf extracted once;
costs/film_net.py), times the new frames of the traced run's window
before its traced stretch, over that time, against the configuration's
peak (bf16: 989 TFLOP/s)."""
from film_bench.metrics._readers import mfu_percent


def read(trace, outcome, ctx):
  if not ctx.untraced_units:
    return None
  return mfu_percent(outcome['flops_per_unit'] * ctx.untraced_units,
                     ctx.untraced_s, ctx)
