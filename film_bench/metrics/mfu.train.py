"""The whole step's share of the card's peak, in percent: a film_net-Style
step's FLOPs (the model's forward and backward, VGG-19's towers and the
Gram products; costs/film_net.py) times the steps of the traced run's
window before its traced stretch, over that time, against the
configuration's peak (`mfu_peak`: 67 TFLOP/s for an exact-f32 step, 495
where TF32 is on)."""
from film_bench.metrics._readers import mfu_percent
from film_bench.costs import film_net as costs
from film_bench.drivers import common
from film_bench.reference import training as ref_training


def read(trace, outcome, ctx):
  if not ctx.untraced_units:
    return None
  t = ctx.workload['traffic']
  size = int(t['crop'])
  flops = sum(costs.train_step_flops(common.options_dict(ctx.config),
                                     int(t['batch']), size, size,
                                     ref_training.VGG_CHANNELS).values())
  return mfu_percent(flops * ctx.untraced_units, ctx.untraced_s, ctx)
