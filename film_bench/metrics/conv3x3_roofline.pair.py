"""The port's conv kernel against its roofline, over a request: the sum
of the bounds of its sites in the two extractions (costs/film_net.py, from
shapes) over the kernels' summed time a traced request, in percent."""
from film_bench.metrics._readers import matches
from film_bench.costs import film_net as costs
from film_bench.drivers import common

KERNELS = ('conv3x3_wgmma_kernel', 'conv3x3_fma_kernel',
           'conv3x3_split_finish_kernel')


def read(trace, outcome, ctx):
  spans = trace.named('request')
  t, align = ctx.workload['traffic'], int(ctx.config.get('align', 64))
  timed = sum(e.dur for s in spans
              for e in trace.device_in(s.start, s.end, kernels_only=True)
              if matches(e.name, KERNELS))
  if not spans or not timed:
    return None
  bound_ms = costs.conv_bound_ms(
      common.options_dict(ctx.config), 1,
      common.padded(int(t['height']), align),
      common.padded(int(t['width']), align), 2,
      ctx.config['model']['dtype_policy'])
  return 100.0 * bound_ms * len(spans) / (timed / 1e3)
