"""Coarse-to-fine residual flow estimation for film_net.

Port of frame_interpolation_tpu/models/flow_estimator.py: the coarsest
level predicts a 'DC' flow; each finer level upsamples the accumulated flow
(x2 magnitude and resolution, bilinear), backward-warps pyramid B's
features with it, and predicts a residual from (A, warped B). The
`specialized_levels` finest levels have their own predictors; all coarser
levels share one.

Flow values and the warp's coordinate math stay f32 under the bf16 policy.
The first conv takes (A, warped B) as two pieces or as their concat, as
`Options.split_convs` says (models/layers.py); the folded forms of the JAX
package are TPU layouts and are not ported. Each conv and its leaky relu
go through `Conv.conv_leaky`: on the card the 3x3 convs run as one kernel
each (ops/conv3x3_pieces.py), the first on both pieces at once.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops import resize
from ..ops import warp as warp_ops
from ..options import Options
from .layers import Conv, conv_input


class FlowEstimator(nn.Module):
  """N 3x3 convs + a 1x1 conv (filters/2) + a 1x1 2-channel f32 conv."""

  def __init__(self, num_convs: int, num_filters: int, in_channels: int,
               options: Options):
    super().__init__()
    self.num_convs = num_convs
    self.split_convs = options.split_convs
    cin = in_channels
    for i in range(num_convs):
      self.add_module(f'conv_{i}',
                      Conv(cin, num_filters, 3, options.compute_dtype))
      cin = num_filters
    self.add_module(f'conv_{num_convs}',
                    Conv(num_filters, num_filters // 2, 1,
                         options.compute_dtype))
    # The flow output conv computes in f32 under every policy.
    self.add_module(f'conv_{num_convs + 1}',
                    Conv(num_filters // 2, 2, 1, torch.float32))

  def forward(self, features_a: torch.Tensor,
              features_b: torch.Tensor) -> torch.Tensor:
    net = conv_input([features_a, features_b], self.split_convs)
    for i in range(self.num_convs + 1):
      net = getattr(self, f'conv_{i}').conv_leaky(net)
    return getattr(self, f'conv_{self.num_convs + 1}')(net.float())


class PyramidFlowEstimator(nn.Module):
  """Predicts optical flow by coarse-to-fine refinement."""

  def __init__(self, options: Options):
    super().__init__()
    self.specialized_levels = options.specialized_levels
    for i in range(options.specialized_levels):
      self.add_module(
          f'flow_predictor_{i}',
          FlowEstimator(options.flow_convs[i], options.flow_filters[i],
                        2 * options.feature_channels(i), options))
    self.flow_predictor_shared = FlowEstimator(
        options.flow_convs[-1], options.flow_filters[-1],
        2 * options.feature_channels(options.specialized_levels), options)

  def _predictor(self, level: int) -> FlowEstimator:
    if level < self.specialized_levels:
      return getattr(self, f'flow_predictor_{level}')
    return self.flow_predictor_shared

  def forward(self, feature_pyramid_a: List[torch.Tensor],
              feature_pyramid_b: List[torch.Tensor]) -> List[torch.Tensor]:
    """Returns the residual flow pyramid, finest level first."""
    levels = len(feature_pyramid_a)
    v = self._predictor(levels - 1)(feature_pyramid_a[-1],
                                    feature_pyramid_b[-1])
    residuals = [v]
    for i in reversed(range(levels - 1)):
      h, w = feature_pyramid_a[i].shape[1], feature_pyramid_a[i].shape[2]
      # Upsample the flow to this level; x2 magnitude for the new scale.
      v = resize.resize_bilinear(2.0 * v, (h, w))
      warped = warp_ops.backward_warp(feature_pyramid_b[i], v).to(
          feature_pyramid_b[i].dtype)
      v_residual = self._predictor(i)(feature_pyramid_a[i], warped)
      residuals.append(v_residual)
      v = v_residual + v
    return list(reversed(residuals))
