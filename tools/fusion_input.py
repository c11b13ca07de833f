#!/usr/bin/env python3
"""The fusion's input built by concats and in place, on one CUDA GPU.

  python3 tools/fusion_input.py [--iters 20]

The released model under the bf16 policy, weights from seed 0, on a
1088x1920 pair of random frames: the two frames' features and the
midpoint's flows are computed once, then, by CUDA events (each the mean
of `--iters` calls after one; the device's time, queued behind a spin):
  * per fusion level, the concat path's two warps of the 3 + C channel
    (image, features) stacks against the in-place path's four warps into
    the level's buffer (features at the vector route, images at the run
    route);
  * the whole assembly of the 5 levels, by concats (the two stacks, two
    warps, three aligned concats a level) and in place
    (`Fusion.align_in_place`);
  * the assembly with the fusion decoder, by each route (`Fusion.forward`
    on the concats, `Fusion.forward_in_place`).
Each line is JSON and names the card and its power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.models import fusion  # noqa: E402
from frame_interpolation_tpu_torch.ops import pyramid as pyramid_ops  # noqa: E402
from frame_interpolation_tpu_torch.ops import warp  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402


def concat_assembly(images, features, backward_flow, forward_flow, dtype):
  """models/film_net.py's concat path, up to the fusion's input."""
  warped = [pyramid_ops.pyramid_warp(
      pyramid_ops.concatenate_pyramids(images[k], features[k]), flow)
            for k, flow in ((0, backward_flow), (1, forward_flow))]
  aligned = pyramid_ops.concatenate_pyramids(*warped)
  aligned = pyramid_ops.concatenate_pyramids(
      aligned, [f.to(dtype) for f in backward_flow])
  return pyramid_ops.concatenate_pyramids(
      aligned, [f.to(dtype) for f in forward_flow])


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--iters', type=int, default=20)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('fusion_input: needs a CUDA GPU')
  card = measure.card_line()
  options = Options.film_net_released(dtype_policy='bfloat16')
  dtype = options.compute_dtype
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  g = torch.Generator().manual_seed(1)
  levels = options.fusion_pyramid_levels
  with torch.inference_mode():
    frames = [torch.rand(1, 1088, 1920, 3, generator=g).cuda()
              for _ in range(2)]
    images, features = zip(*(model.extract_features(x) for x in frames))
    images = [p[:levels] for p in images]
    features = [p[:levels] for p in features]
    flows = []
    for a, b in ((1, 0), (0, 1)):  # backward flow, then forward flow
      residual = model.predict_flow(features[a], features[b])
      flows.append([0.5 * f for f in
                    pyramid_ops.flow_pyramid_synthesis(residual)[:levels]])
    backward_flow, forward_flow = flows

    def ms(fn):
      return measure.time_ms(fn, iters=args.iters)

    for level in range(levels):
      c = features[0][level].shape[-1]
      layout = fusion.packed_layout(c)
      stacks = [torch.cat([images[k][level], features[k][level]], -1)
                for k in range(2)]
      buffer = torch.empty(features[0][level].shape[:3] + (layout.channels,),
                           dtype=dtype, device='cuda')
      flow0, flow1 = backward_flow[level], forward_flow[level]
      print(json.dumps({
          'card': card, 'level': level,
          'shape': list(features[0][level].shape[:3]), 'C': c,
          'pitch': layout.channels,
          'stack_warps_ms': ms(lambda: (warp.backward_warp(stacks[0], flow0),
                                        warp.backward_warp(stacks[1], flow1))),
          'feature_warps_into_ms': ms(lambda: (
              warp.backward_warp_into(features[0][level], flow0, buffer,
                                      layout.features0),
              warp.backward_warp_into(features[1][level], flow1, buffer,
                                      layout.features1))),
          'image_warps_into_ms': ms(lambda: (
              warp.backward_warp_into(images[0][level], flow0, buffer,
                                      layout.image0),
              warp.backward_warp_into(images[1][level], flow1, buffer,
                                      layout.image1))),
      }))
    pyramids = (images, features, backward_flow, forward_flow)

    def by_concats():
      return model.fusion(concat_assembly(*pyramids, dtype))

    def in_place():
      return model.fusion.forward_in_place(*pyramids)[0]

    print(json.dumps({
        'card': card, 'levels': levels,
        'concat_assembly_ms': ms(lambda: concat_assembly(*pyramids, dtype)),
        'in_place_assembly_ms': ms(
            lambda: model.fusion.align_in_place(*pyramids)),
        'concat_fusion_ms': ms(by_concats),
        'in_place_fusion_ms': ms(in_place),
        'fusion_max_abs_gap': float(
            (by_concats().float() - in_place().float()).abs().max()),
    }))
  return 0


if __name__ == '__main__':
  sys.exit(main())
