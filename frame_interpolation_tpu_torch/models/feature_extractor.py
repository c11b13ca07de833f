"""Cascaded feature pyramid extractor for the film_net interpolator.

Port of frame_interpolation_tpu/models/feature_extractor.py: one
`SubTreeExtractor` (two 3x3 convs per level, filters doubling per level,
2x2 average pool between levels) runs at every image-pyramid level, and
the cascaded features are channel concats of same-resolution subtree
levels: feat_i = concat(S_i_0, S_{i-1}_1, ...).

The conv stacks go through ops/conv_stack.conv3x3_leaky (the hand-written
kernel on CUDA, with the 2x2 pool fused wherever a next level follows) at
the sites the TPU kernels covered:
  * the second conv of every sub-level (cfeat_conv_1/3/5/7);
  * the first conv of sub-levels 2 and up (cfeat_conv_4/6: 128->256 and
    256->512 in the released config), as conv_stack_wide.py does.
cfeat_conv_0 (3->64) and cfeat_conv_2 (64->128) stay plain convs, as they
stay XLA convs in the JAX package. On CUDA the kernel takes channel counts
that are multiples of 64 and raises for any other, so a CUDA model needs
`filters` to be a multiple of 64; on the CPU any count runs.

Inside a shard of a row-sharded forward (ops/rows.py), a sub-level on a
slab runs its two convs by conv_stack.stack_rows (one 2-row halo for
both), and a pooled slab whose level does not split is gathered whole.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops import conv_stack, rows
from ..options import Options
from .layers import Conv, leaky_relu


class SubTreeExtractor(nn.Module):
  """Conventional hierarchical extractor: 2 convs per level + avg-pool."""

  def __init__(self, options: Options):
    super().__init__()
    k = options.filters
    for i in range(options.sub_levels):
      cin = 3 if i == 0 else k << (i - 1)
      self.add_module(f'cfeat_conv_{2 * i}',
                      Conv(cin, k << i, 3, options.compute_dtype))
      self.add_module(f'cfeat_conv_{2 * i + 1}',
                      Conv(k << i, k << i, 3, options.compute_dtype))

  def forward(self, image: torch.Tensor, n: int) -> List[torch.Tensor]:
    """Extracts `n` pyramid levels of features from `image` (finest first)."""
    head = image
    pyramid = []
    shard = rows.current()
    for i in range(n):
      first = getattr(self, f'cfeat_conv_{2 * i}')
      second = getattr(self, f'cfeat_conv_{2 * i + 1}')
      pool = i < n - 1
      if i >= 2:
        def first_conv(x, first=first):
          return conv_stack.conv3x3_leaky(x, first.weight, first.bias)[0]
      else:
        def first_conv(x, first=first):
          return leaky_relu(first.conv(x))
      if shard is not None and shard.split(head):
        feat, pooled = conv_stack.stack_rows(head, first_conv, second.weight,
                                             second.bias, pool, shard)
        if pool:
          pooled = shard.settle(pooled)
      else:
        feat, pooled = conv_stack.conv3x3_leaky(
            first_conv(head), second.weight, second.bias, pool=pool)
      pyramid.append(feat)
      if pool:
        head = pooled
    return pyramid


class FeatureExtractor(nn.Module):
  """Cascaded feature pyramid from an image pyramid.

  The same SubTreeExtractor (shared weights) runs at every image level,
  its depth capped so no features extend beyond the coarsest level.
  """

  def __init__(self, options: Options):
    super().__init__()
    self.sub_levels = options.sub_levels
    self.sub_extractor = SubTreeExtractor(options)

  def forward(self,
              image_pyramid: List[torch.Tensor]) -> List[torch.Tensor]:
    levels = len(image_pyramid)
    sub_pyramids = [
        self.sub_extractor(image_pyramid[i], min(levels - i, self.sub_levels))
        for i in range(levels)
    ]
    feature_pyramid = []
    for i in range(levels):
      parts = [sub_pyramids[i][0]]
      for j in range(1, self.sub_levels):
        if j <= i:
          parts.append(sub_pyramids[i - j][j])
      feature_pyramid.append(torch.cat(parts, dim=-1))
    return feature_pyramid
