"""The cost arithmetic against the numbers the port's own tools gave."""
import dataclasses

import pytest

from film_bench.costs import film_net as costs
from film_bench.costs import peaks
from film_bench.reference import training as ref_training


@pytest.fixture
def released():
  from frame_interpolation_tpu_torch.options import Options
  return dataclasses.asdict(Options.film_net_released())


def test_pair_flops_match_the_ports_count(released):
  # PERF.md: a 1088x1920 pair, 8.87 TFLOP.
  assert costs.pair_flops(released, 1, 1088, 1920) == pytest.approx(
      8.87e12, rel=1e-3)


def test_conv_sites_and_bound_match_conv_sites_tool(released):
  # tools/conv_sites.py: 62 sites a pair, bound 2.14 ms in bf16.
  assert len(costs.conv_sites(released, 1, 1088, 1920)) * 2 == 62
  assert costs.conv_bound_ms(released, 1, 1088, 1920, 2,
                             'bfloat16') == pytest.approx(2.14, abs=5e-3)


def test_splat_sites_of_a_step(released):
  # 22 warps a step, each with one splat; the 8x256x256x67 site's bound
  # is PERF.md's 0.085 ms.
  sites = costs.warp_sites(released, 8, 256, 256)
  assert len(sites) == 22
  assert (8, 256, 256, 67) in sites
  elements = 8 * 256 * 256 * 67
  assert peaks.bound_ms(8.0 * elements, elements * 8 + 8 * 256 * 256 * 8,
                        peaks.PEAK_FLOPS['float32']) == pytest.approx(
                            0.085, abs=1e-3)


def test_the_port_has_the_convs_the_costs_count(released):
  from frame_interpolation_tpu_torch.models.film_net import FilmNet
  from frame_interpolation_tpu_torch.options import Options
  model = FilmNet(Options.film_net_released())
  # Every conv of the model appears in the count with its widths: the
  # extractor's once per level, the predictors' and fusion's once.
  shapes = sorted(tuple(p.shape[:2]) for n, p in model.named_parameters()
                  if n.endswith('weight'))
  counted = {(c.cout, c.cin) for c in costs.extraction_convs(
      released, 1, 128, 128) + costs.midpoint_convs(released, 1, 128, 128)}
  assert set(shapes) == counted


def test_tree_and_step_totals(released):
  per_frame = costs.tree_flops_per_new_frame(released, 1088, 1920, 33, 3)
  mid = costs.flops(costs.midpoint_convs(released, 1, 1088, 1920))
  extract = costs.flops(costs.extraction_convs(released, 1, 1088, 1920))
  assert per_frame == pytest.approx(mid + extract * (33 + 32 * 3) / 224)
  step = costs.train_step_flops(released, 8, 256, 256,
                                ref_training.VGG_CHANNELS)
  assert sum(step.values()) == pytest.approx(7.912e12, rel=1e-3)
