"""Pyramid algebra for the FILM interpolator, on NHWC tensors.

Port of frame_interpolation_tpu/ops/pyramid.py. Pyramids are plain Python
lists of (B, H, W, C) tensors, finest level first. Inside a shard of a
row-sharded forward (ops/rows.py) the pool of a slab stays local (the
slabs are even) and is gathered whole where the level below does not
split.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from . import resize, rows
from . import warp as warp_ops


def avg_pool_2x(image: torch.Tensor) -> torch.Tensor:
  """2x2 stride-2 VALID average pooling (odd extents floor)."""
  pooled = F.avg_pool2d(image.permute(0, 3, 1, 2), 2)
  pooled = pooled.permute(0, 2, 3, 1).contiguous()
  shard = rows.current()
  if shard is not None and shard.split(image):
    return shard.settle(pooled)
  return pooled


def build_image_pyramid(image: torch.Tensor,
                        levels: int) -> List[torch.Tensor]:
  """Builds `levels` images, original first, each successive one half-size."""
  pyramid = []
  for i in range(levels):
    pyramid.append(image)
    if i < levels - 1:
      image = avg_pool_2x(image)
  return pyramid


def multiply_pyramid(pyramid: Sequence[torch.Tensor],
                     scalar: torch.Tensor) -> List[torch.Tensor]:
  """Multiplies each level by a per-batch scalar of shape (B,)."""
  return [image * scalar[:, None, None, None].to(image.dtype)
          for image in pyramid]


def flow_pyramid_synthesis(
    residual_pyramid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """Converts a residual flow pyramid (finest first) into absolute flows.

  Coarse to fine: each finer flow is the 2x-upsampled, 2x-scaled coarser
  flow plus the residual at that level.
  """
  flow = residual_pyramid[-1]
  flow_pyramid = [flow]
  for residual_flow in reversed(list(residual_pyramid)[:-1]):
    h, w = residual_flow.shape[1], residual_flow.shape[2]
    flow = resize.resize_bilinear(2.0 * flow, (h, w)).to(flow.dtype)
    flow = residual_flow + flow
    flow_pyramid.append(flow)
  return list(reversed(flow_pyramid))


def pyramid_warp(feature_pyramid: Sequence[torch.Tensor],
                 flow_pyramid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """Backward-warps each feature level with the matching flow level."""
  return [warp_ops.backward_warp(features, flow)
          for features, flow in zip(feature_pyramid, flow_pyramid)]


def concatenate_pyramids(
    pyramid1: Sequence[torch.Tensor],
    pyramid2: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """Concatenates matching levels along channels."""
  return [torch.cat([a, b], dim=-1) for a, b in zip(pyramid1, pyramid2)]
