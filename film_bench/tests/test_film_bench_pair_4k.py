"""The pair-4k-f32 cell's files: its configuration states every option of
the released model in f32, its workload is the pair driver's, and the TF32
conv's roofline reader takes the 62 sites' bounds at the TF32 peak; on
the card, the cell's set-up under the configuration's TF32 switches takes
the TF32 route at every conv site."""
import time
import types

import pytest
import torch

from film_bench import bench
from film_bench import trace as trace_lib
from film_bench.costs import film_net as costs
from film_bench.drivers import common

TF32_CONV = 'void (anonymous namespace)::conv3x3_wgmma_kernel<float, 256>(x)'
FMA_CONV = 'void (anonymous namespace)::conv3x3_fma_kernel<128>(x)'


def _event(name, start, dur, cat='kernel'):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': start, 'dur': dur}


def _ctx():
  workload = bench.load_json('workloads', 'pair-4k-f32')
  config = bench.load_json('configs', workload['config'])
  return types.SimpleNamespace(workload=workload, config=config)


def _trace(kernel):
  """Two requests of 400 ms, each with 30 ms of `kernel`."""
  events = [_event('film_bench.window', 0, 1_000_000, 'user_annotation')]
  for start in (0, 500_000):
    events += [_event('film_bench.request', start, 400_000,
                      'user_annotation'),
               _event(kernel, start + 1_000, 30_000)]
  return trace_lib.Trace(events)


def test_the_configuration_is_the_released_model_in_f32():
  from frame_interpolation_tpu_torch.options import Options
  ctx = _ctx()
  model = ctx.config['model']
  assert set(model) == set(Options.__dataclass_fields__)
  bf16 = bench.load_json('configs', 'film_net-released-bf16')['model']
  assert {k: v for k, v in model.items() if k != 'dtype_policy'} == {
      k: v for k, v in bf16.items() if k != 'dtype_policy'}
  assert model['dtype_policy'] == 'float32'
  assert ctx.config['mfu_peak'] == 'tf32'
  assert ctx.workload['entry'] == 'pair'
  t = ctx.workload['traffic']
  assert (t['height'], t['width']) == (2160, 3840)
  assert common.padded(t['height'], ctx.config['align']) == 2176


def test_tf32_roofline_reads_the_sites_at_the_tf32_peak():
  ctx = _ctx()
  reader = bench.load_reader('conv3x3_tf32_roofline.pair')
  bound_ms = costs.conv_bound_ms(common.options_dict(ctx.config), 1, 2176,
                                 3840, 2, 'tf32')
  assert 5.0 < bound_ms < 30.0
  got = reader.read(_trace(TF32_CONV), {}, ctx)
  assert got == pytest.approx(100.0 * bound_ms / 30.0)


def test_tf32_roofline_reads_nothing_without_the_tf32_kernel():
  reader = bench.load_reader('conv3x3_tf32_roofline.pair')
  assert reader.read(_trace(FMA_CONV), {}, _ctx()) is None


@pytest.mark.card
def test_the_cell_takes_the_tf32_route_at_every_site(card):
  """The pair driver's set-up of this cell (its configuration, frames cut
  to 256x448) under the switches the configuration states: every conv
  launch of every forward takes the TF32 route, 62 a forward."""
  from frame_interpolation_tpu_torch.ops import _kernels
  workload = bench.load_json('workloads', 'pair-4k-f32')
  config = bench.load_json('configs', workload['config'])
  workload['traffic'].update(height=256, width=448, pool=2)
  ctx = bench.Context('pair-4k-f32', workload, config, 2**31 + 19, 1.0,
                      False, torch.device('cuda', 0), time.perf_counter())
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = config['cudnn_allow_tf32']
  torch.backends.cuda.matmul.allow_tf32 = config['matmul_allow_tf32']
  try:
    _kernels.reset_launch_counts()
    bench.load_driver(workload['entry']).Driver(ctx).setup()
    counts = _kernels.launch_counts()
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
  convs = counts['conv3x3_c64'] + counts['conv3x3_wide']
  assert convs > 0 and convs % 62 == 0
  assert counts['conv3x3_tf32'] == convs
