"""U-Net style fusion decoder for film_net.

Port of frame_interpolation_tpu/models/fusion.py: from the coarsest
aligned-feature level, each finer level does nearest x2 upsampling, a 2x2
conv (TF-asymmetric SAME padding), a concat with the skip connection and
two 3x3 convs with leaky-relu (the first of them takes the skip and the
upsampled features as two pieces where `Options.split_convs` splits, and
the concat is not built); a final f32 1x1 conv produces RGB. The
coarsest level has no convs. Filter counts double per finer level up to
`specialized_levels`.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops import resize
from ..options import Options
from .layers import Conv, conv_input, leaky_relu

_NUMBER_OF_COLOR_CHANNELS = 3


class Fusion(nn.Module):
  """The decoder. Input: the aligned feature pyramid, finest first."""

  def __init__(self, options: Options):
    super().__init__()
    self.levels = options.fusion_pyramid_levels
    self.split_convs = options.split_convs
    k, m = options.filters, options.specialized_levels
    dtype = options.compute_dtype

    def filters(i):
      return (k << i) if i < m else (k << m)

    def aligned_channels(i):
      # Two warped (image, features) stacks plus two 2-channel flows.
      return 2 * (3 + options.feature_channels(i)) + 4

    for i in range(self.levels - 1):
      coarser = (aligned_channels(i + 1) if i == self.levels - 2
                 else filters(i + 1))
      self.add_module(f'conv_{i}_0', Conv(coarser, filters(i), 2, dtype))
      self.add_module(f'conv_{i}_1',
                      Conv(aligned_channels(i) + filters(i), filters(i), 3,
                           dtype))
      self.add_module(f'conv_{i}_2', Conv(filters(i), filters(i), 3, dtype))
    self.output_conv = Conv(filters(0), _NUMBER_OF_COLOR_CHANNELS, 1,
                            torch.float32)

  def forward(self, pyramid: List[torch.Tensor]) -> torch.Tensor:
    if len(pyramid) != self.levels:
      raise ValueError(
          'Fusion called with different number of pyramid levels '
          f'{len(pyramid)} than it was configured for, {self.levels}.')
    net = pyramid[-1]
    for i in reversed(range(self.levels - 1)):
      entry = pyramid[i]
      net = resize.resize_nearest(net, (entry.shape[1], entry.shape[2]))
      net = getattr(self, f'conv_{i}_0')(net)  # 2x2 conv, no activation
      net = conv_input([entry, net], self.split_convs)
      net = leaky_relu(getattr(self, f'conv_{i}_1')(net))
      net = leaky_relu(getattr(self, f'conv_{i}_2')(net))
    return self.output_conv(net.float())
