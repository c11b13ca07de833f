"""The port's splat (the warp's image gradient, csrc/splat.cu) against its
roofline over the traced steps, in percent: the bound of a step's splat
sites (costs/film_net.py, bytes from shapes) times the steps traced, over
the splat kernels' summed time. Each splat launches the scan kernel once,
so the traced steps are its launches over the sites a step."""
from film_bench.metrics._readers import matches
from film_bench.costs import film_net as costs
from film_bench.drivers import common

KERNELS = ('splat_index_kernel', 'splat_scan_kernel', 'splat_tile_sum_kernel',
           'splat_long_sum_kernel')
COUNTED = 'splat_scan_kernel'


def read(trace, outcome, ctx):
  ops = [e for e in trace.kernels() if matches(e.name, KERNELS)
         and trace.start <= e.start < trace.end]
  launches = sum(1 for e in ops if matches(e.name, (COUNTED,)))
  if not launches:
    return None
  t = ctx.workload['traffic']
  options = common.options_dict(ctx.config)
  size = int(t['crop'])
  sites = len(costs.warp_sites(options, int(t['batch']), size, size))
  bound_ms = costs.splat_bound_ms(options, int(t['batch']), size, size)
  return 100.0 * bound_ms * (launches / sites) / (sum(e.dur for e in ops) / 1e3)
