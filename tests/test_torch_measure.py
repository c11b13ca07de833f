"""The measurement scripts' yardstick (frame_interpolation_tpu_torch.utils.
measure), on the CPU.

The library calls that `chip_smoke.py` times beside the warp and the splat
must compute the same function as the port's plain versions, and the bounds
must count the work the ROADMAP and PERF tables quote.
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu_torch.ops import warp
from frame_interpolation_tpu_torch.utils import measure


def _flow(kind, b, h, w):
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
  flow = np.stack([9 * np.sin(yy / 7.0) * np.cos(xx / 5.0),
                   9 * np.cos(yy / 3.0) * np.sin(xx / 11.0)], axis=-1)
  flow[:, :w // 2] += 4.0
  if kind == 'integer':
    flow = np.round(flow)
  elif kind == 'oob':
    flow = flow * 20.0
  return torch.from_numpy(np.ascontiguousarray(
      np.broadcast_to(flow[None], (b, h, w, 2)), np.float32))


@pytest.mark.parametrize('kind', ['seam', 'integer', 'oob'])
@pytest.mark.parametrize('b,h,w,c', [(2, 17, 30, 5), (1, 40, 64, 3)])
def test_grid_sampler_computes_the_warp_and_its_splat(kind, b, h, w, c):
  rng = np.random.RandomState(h + w)
  image = torch.from_numpy(rng.rand(b, h, w, c).astype(np.float32))
  g = torch.from_numpy((rng.rand(b, h, w, c) - 0.5).astype(np.float32))
  flow = _flow(kind, b, h, w)
  grid = measure.bilinear_grid(flow)

  sampled = torch.nn.functional.grid_sample(
      image.permute(0, 3, 1, 2), grid, mode='bilinear', padding_mode='border',
      align_corners=True).permute(0, 2, 3, 1)
  want = warp.backward_warp_plain(image, flow)
  assert (sampled - want).abs().max().item() <= 1e-5

  grad_image, _ = torch.ops.aten.grid_sampler_2d_backward(
      g.permute(0, 3, 1, 2), torch.zeros_like(image).permute(0, 3, 1, 2),
      grid, 0, 1, True, [True, False])
  splat = warp.splat_plain(g, flow)
  rel = ((grad_image.permute(0, 2, 3, 1) - splat).abs().max() /
         splat.abs().max()).item()
  assert rel <= 1e-5


@pytest.mark.parametrize('site,gflop,gbytes,bound_by', [
    ((1, 1088, 1920, 64, 64, True, 2), 154.0, 0.602, 'bytes'),
    ((1, 136, 240, 512, 512, False, 2), 154.0, 0.07157, 'operations'),
    ((8, 16, 16, 512, 512, False, 4), 9.664, 0.0178, 'operations'),
])
def test_conv_cost_and_bound(site, gflop, gbytes, bound_by):
  flops, nbytes = measure.conv_cost(*site)
  assert flops / 1e9 == pytest.approx(gflop, rel=2e-3)
  assert nbytes / 1e9 == pytest.approx(gbytes, rel=2e-3)
  peak = measure.PEAK_FLOPS['bfloat16' if site[-1] == 2 else 'tf32']
  bound = measure.roofline(flops, nbytes, peak)
  assert bound['bound_by'] == bound_by
  assert bound['bound_ms'] == max(bound['bound_ops_ms'],
                                  bound['bound_bytes_ms'])
  assert bound['bound_ops_ms'] == pytest.approx(1e3 * flops / peak)
