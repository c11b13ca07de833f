"""The film_net frame interpolator: the full model (PyTorch).

Port of frame_interpolation_tpu/models/film_net.py:

  image pyramids -> siamese cascaded feature pyramids (shared weights)
  -> bidirectional coarse-to-fine residual flows (one shared estimator,
     called once per direction)
  -> residual->absolute flow synthesis, truncated to the fusion levels
  -> flows scaled by t (backward) and 1-t (forward), with t pinned to 0.5
  -> backward warp of the concat(image, features) pyramids
  -> aligned-pyramid concat -> fusion decoder -> RGB + aux outputs.

Where no gradient is asked for (autograd records nothing, or nothing
that reaches the fusion requires grad) and no row shard is installed
(ops/rows.py), the fusion builds the aligned pyramid in place instead
(models/fusion.py `Fusion.forward_in_place`: one buffer a level, whose
channels the warps, the flows and a fill of the pad write), so no concat
copies a warped level again. Training and the row-sharded forward keep
the concat path: a warp into a buffer carries no gradient, and a shard's
slab is warped in row mode. The route is chosen from that state alone.

Parameter names follow the flax tree (feat_net/sub_extractor/cfeat_conv_k,
predict_flow/flow_predictor_{i,shared}/conv_k, fusion/conv_{i}_{j},
fusion/output_conv), so io/params_io.py maps one tree onto the other.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops import pyramid as pyramid_ops
from ..ops import rows
from ..options import Options
from .feature_extractor import FeatureExtractor
from .flow_estimator import PyramidFlowEstimator
from .fusion import Fusion
from .layers import Conv

Features = Tuple[List[torch.Tensor], List[torch.Tensor]]


class FilmNet(nn.Module):
  """Frame interpolator model. Call with (x0, x1, time) NHWC batches."""

  def __init__(self, options: Options):
    super().__init__()
    self.options = options
    self.feat_net = FeatureExtractor(options)
    self.predict_flow = PyramidFlowEstimator(options)
    self.fusion = Fusion(options)

  def extract_features(self, x: torch.Tensor) -> Features:
    """Image + feature pyramids for ONE frame (reusable across pairs)."""
    decoded = x.to(self.options.compute_dtype)
    image_pyramid = pyramid_ops.build_image_pyramid(
        decoded, self.options.pyramid_levels)
    return image_pyramid, self.feat_net(image_pyramid)

  def forward(self, x0: torch.Tensor, x1: torch.Tensor,
              time: torch.Tensor) -> Dict[str, object]:
    features0 = self.extract_features(x0)
    features1 = self.extract_features(x1)
    return self.interpolate_from_features(features0, features1, time)

  def interpolate_from_features(self, features0: Features,
                                features1: Features,
                                time: torch.Tensor) -> Dict[str, object]:
    """Interpolates from precomputed (image_pyramid, feature_pyramid) pairs.

    `time` is (B, 1) and ignored: film_net predicts the midpoint.
    """
    config = self.options
    compute_dtype = config.compute_dtype
    image_pyramids = [features0[0], features1[0]]
    feature_pyramids = [features0[1], features1[1]]

    forward_residual_flow_pyramid = self.predict_flow(feature_pyramids[0],
                                                      feature_pyramids[1])
    backward_residual_flow_pyramid = self.predict_flow(feature_pyramids[1],
                                                       feature_pyramids[0])

    levels = config.fusion_pyramid_levels
    forward_flow_pyramid = pyramid_ops.flow_pyramid_synthesis(
        forward_residual_flow_pyramid)[:levels]
    backward_flow_pyramid = pyramid_ops.flow_pyramid_synthesis(
        backward_residual_flow_pyramid)[:levels]

    mid_time = torch.full((time.shape[0],), 0.5, dtype=torch.float32,
                          device=time.device)
    backward_flow = pyramid_ops.multiply_pyramid(backward_flow_pyramid,
                                                 mid_time)
    forward_flow = pyramid_ops.multiply_pyramid(forward_flow_pyramid,
                                                1.0 - mid_time)

    image_pyramids = [p[:levels] for p in image_pyramids]
    feature_pyramids = [p[:levels] for p in feature_pyramids]
    inputs = (*image_pyramids[0], *image_pyramids[1], *feature_pyramids[0],
              *feature_pyramids[1], *backward_flow, *forward_flow,
              *self.fusion.parameters())
    if rows.current() is None and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
      prediction, x0_warped, x1_warped = self.fusion.forward_in_place(
          image_pyramids, feature_pyramids, backward_flow, forward_flow)
    else:
      pyramids_to_warp = [
          pyramid_ops.concatenate_pyramids(image_pyramids[0],
                                           feature_pyramids[0]),
          pyramid_ops.concatenate_pyramids(image_pyramids[1],
                                           feature_pyramids[1]),
      ]
      # Backward warping: the backward flow reads from image 0, the forward
      # flow from image 1.
      forward_warped_pyramid = pyramid_ops.pyramid_warp(pyramids_to_warp[0],
                                                        backward_flow)
      backward_warped_pyramid = pyramid_ops.pyramid_warp(pyramids_to_warp[1],
                                                         forward_flow)

      aligned_pyramid = pyramid_ops.concatenate_pyramids(
          forward_warped_pyramid, backward_warped_pyramid)
      aligned_pyramid = pyramid_ops.concatenate_pyramids(
          aligned_pyramid, [f.to(compute_dtype) for f in backward_flow])
      aligned_pyramid = pyramid_ops.concatenate_pyramids(
          aligned_pyramid, [f.to(compute_dtype) for f in forward_flow])

      prediction = self.fusion(aligned_pyramid)
      x0_warped = forward_warped_pyramid[0][..., 0:3]
      x1_warped = backward_warped_pyramid[0][..., 0:3]
    outputs = {'image': prediction[..., :3].float()}
    if config.use_aux_outputs:
      outputs.update({
          'x0_warped': x0_warped.float(),
          'x1_warped': x1_warped.float(),
          'forward_residual_flow_pyramid': forward_residual_flow_pyramid,
          'backward_residual_flow_pyramid': backward_residual_flow_pyramid,
          'forward_flow_pyramid': forward_flow_pyramid,
          'backward_flow_pyramid': backward_flow_pyramid,
      })
    return outputs


def create_model(options: Options) -> FilmNet:
  """A FilmNet with zero weights; see `init_params` for random ones."""
  return FilmNet(options)


def init_params(model: FilmNet, generator: torch.Generator) -> FilmNet:
  """Fills every conv with lecun-normal kernels and zero biases, in place.

  The weights come from `generator` alone, in module order, so one seed
  gives one model. The generator and the model must be on the same device
  (build on the CPU, then move the model).
  """
  for module in model.modules():
    if isinstance(module, Conv):
      module.reset_parameters(generator)
  return model
