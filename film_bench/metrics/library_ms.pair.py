"""Device ms a request in kernels that are not the port's own (cuDNN,
cuBLAS, torch.cat, elementwise, copies): the traced requests' kernels
less those named below, the mean over the requests."""
from film_bench.metrics._readers import matches

PORT_KERNELS = (
    'conv3x3_wgmma_kernel', 'conv3x3_fma_kernel',
    'conv3x3_split_finish_kernel', 'warp_vector_kernel', 'warp_run_kernel',
    'splat_index_kernel', 'splat_scan_kernel', 'splat_tile_sum_kernel',
    'splat_long_sum_kernel')


def read(trace, outcome, ctx):
  spans = trace.named('request')
  if not spans:
    return None
  total = sum(e.dur for s in spans
              for e in trace.device_in(s.start, s.end, kernels_only=True)
              if not matches(e.name, PORT_KERNELS))
  return total / len(spans) / 1e3
