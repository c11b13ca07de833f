"""Model hyperparameter options for the film_net interpolator (PyTorch).

Mirrors frame_interpolation_tpu/options.py field for field and value for
value, minus the knobs that choose between TPU execution layouts
(`warp_impl`, `fold_convs`, `conv_stack`). The port has one route per
device for those instead: a CUDA tensor always goes through the
hand-written kernels, a CPU tensor always through their plain PyTorch
versions. `split_convs` is kept: it chooses between two forms of the same
convs on every device (models/layers.py).

The maximum motion the model resolves is 2^(pyramid_levels-1) *
flow_convs[-1] pixels; inputs must be divisible by 2^(pyramid_levels-1).
The released checkpoints use `Options.film_net_released()`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Options:
  """Options for the film_net video frame interpolator.

  Attributes:
    pyramid_levels: levels for the feature pyramid and flow prediction.
    fusion_pyramid_levels: levels used by the fusion decoder; must be <=
      pyramid_levels.
    specialized_levels: number of finest levels with unshared weights.
    flow_convs: 3x3 convs per residual flow predictor; specialized_levels+1
      entries, the last for all shared coarse levels.
    flow_filters: filters per residual flow predictor, same layout.
    sub_levels: depth of the cascaded feature subtrees.
    filters: base feature count; doubles per sub-level.
    use_aux_outputs: include aux outputs (warped images, flow pyramids).
    dtype_policy: 'float32', or 'bfloat16' for bf16 conv compute with f32
      accumulation (parameters stay f32; flow values, warp coordinates and
      weights, the last flow conv and the output conv stay f32).
    split_convs: how a conv whose input is a channel concat runs (the flow
      predictors' (features, warped features) and the fusion decoder's
      (skip, upsampled) inputs). 'on': one conv per piece with the
      weight's slice of input channels, the partial outputs summed in the
      compute dtype and the bias added once, so the concat is never
      written (the JAX package's split form). 'off': the conv of the
      concat. 'auto', the default: the split form on every device, as
      the JAX package's default, and the form that the H100 ran faster at
      the 1080p bf16 pair (models/layers.should_split). The two forms
      compute the same function up to accumulation order (and, under
      bf16, one more rounding of each partial output).
  """
  pyramid_levels: int = 5
  fusion_pyramid_levels: int = 5
  specialized_levels: int = 3
  flow_convs: Tuple[int, ...] = (4, 4, 4, 4)
  flow_filters: Tuple[int, ...] = (64, 128, 256, 256)
  sub_levels: int = 4
  filters: int = 16
  use_aux_outputs: bool = True
  dtype_policy: str = 'float32'
  split_convs: str = 'auto'

  def __post_init__(self):
    if self.pyramid_levels < self.fusion_pyramid_levels:
      raise ValueError(
          'pyramid_levels must be greater than or equal to '
          'fusion_pyramid_levels.')
    if self.dtype_policy not in ('float32', 'bfloat16'):
      raise ValueError(f'Unknown dtype_policy: {self.dtype_policy}')
    if self.split_convs not in ('auto', 'on', 'off'):
      raise ValueError(f'Unknown split_convs: {self.split_convs}')

  @property
  def compute_dtype(self) -> torch.dtype:
    return torch.bfloat16 if self.dtype_policy == 'bfloat16' else torch.float32

  @property
  def align(self) -> int:
    """Inputs must have H, W divisible by this."""
    return 2**(self.pyramid_levels - 1)

  @property
  def max_motion_px(self) -> int:
    return 2**(self.pyramid_levels - 1) * self.flow_convs[-1]

  def feature_channels(self, level: int) -> int:
    """Cascaded feature channels at a pyramid level.

    feat_i = concat(S_i_0, S_{i-1}_1, ...), where the subtree rooted at
    image level i is capped to min(pyramid_levels - i, sub_levels) levels
    and subtree level j has filters << j channels.
    """
    total = 0
    for j in range(self.sub_levels):
      if j > level:
        break
      i = level - j
      if j < min(self.pyramid_levels - i, self.sub_levels):
        total += self.filters << j
    return total

  @classmethod
  def film_net_released(cls, **overrides) -> 'Options':
    """Hyperparameters of the released L1/VGG/Style checkpoints."""
    values = dict(
        pyramid_levels=7,
        fusion_pyramid_levels=5,
        specialized_levels=3,
        flow_convs=(3, 3, 3, 3),
        flow_filters=(32, 64, 128, 256),
        sub_levels=4,
        filters=64,
        use_aux_outputs=True,
    )
    values.update(overrides)
    return cls(**values)

  @classmethod
  def tiny(cls, **overrides) -> 'Options':
    """A small config for fast tests."""
    values = dict(
        pyramid_levels=4,
        fusion_pyramid_levels=3,
        specialized_levels=2,
        flow_convs=(1, 1, 1),
        flow_filters=(8, 8, 8),
        sub_levels=3,
        filters=4,
        use_aux_outputs=True,
    )
    values.update(overrides)
    return cls(**values)
