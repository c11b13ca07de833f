"""Pair inference: pad -> forward -> crop, with optional patch tiling.

Port of the pair path of frame_interpolation_tpu/inference/interpolator.py.
`interpolate` pads the frames to the alignment grid, runs FilmNet and crops
back; `__call__` also folds the frame into a block_shape grid of patches
and runs them as one batch. Both take and return numpy arrays;
`call_device` takes and returns tensors on the interpolator's device.

The model ignores the time value and predicts the midpoint; other
timestamps come from recursive invocation.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..io import params_io
from ..models.film_net import FilmNet
from ..ops import tiling
from ..options import Options


def _as_model(params_or_model: Any, options: Options) -> FilmNet:
  if isinstance(params_or_model, nn.Module):
    return params_or_model
  if not isinstance(params_or_model, Mapping):
    raise TypeError('expected a FilmNet, a state_dict or a flax parameter '
                    f'tree; got {type(params_or_model).__name__}')
  state = params_or_model
  if any(isinstance(v, Mapping) for v in state.values()):
    state = params_io.from_flax_params(state)
  model = FilmNet(options)
  model.load_state_dict(state)
  return model


class Interpolator:
  """Generates the frame between two frames with the film_net model.

  Usage:
    interp = Interpolator(model, options, align=64, device='cuda')
    mid = interp(x0_batch, x1_batch, dt_batch)   # numpy in, numpy out

  `params_or_model` is a FilmNet, its state_dict, or the JAX package's
  flax parameter tree. A 'cuda' device needs a visible GPU; there is no
  fallback to the CPU.
  """

  def __init__(self, params_or_model: Any, options: Options,
               align: Optional[int] = 64,
               block_shape: Optional[Sequence[int]] = None,
               device: Any = 'cuda') -> None:
    self._device = torch.device(device)
    if self._device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError('Interpolator: device cuda requested but no GPU is '
                         'visible to torch.')
    self._options = options
    self._align = align or None
    self._block_shape = tuple(block_shape) if block_shape else None
    self._model = _as_model(params_or_model, options).to(self._device).eval()

  @property
  def options(self) -> Options:
    return self._options

  @property
  def model(self) -> FilmNet:
    return self._model

  def _tiled(self) -> bool:
    return (self._block_shape is not None and
            int(np.prod(self._block_shape)) > 1)

  def interpolate_device(self, x0: torch.Tensor, x1: torch.Tensor,
                         dt: torch.Tensor) -> torch.Tensor:
    """Pads to alignment, runs the model, crops back. Stays on device.

    x0, x1: (B, H, W, 3) float32 in [0, 1]; dt: (B,). Returns (B, H, W, 3).
    """
    time = dt.reshape(-1, 1).float()
    with torch.inference_mode():
      bbox = None
      if self._align is not None:
        x0, bbox = tiling.pad_to_align(x0, self._align)
        x1, _ = tiling.pad_to_align(x1, self._align)
      image = self._model(x0, x1, time)['image']
      if bbox is not None:
        image = tiling.crop_to_bounding_box(image, **bbox)
      return image.contiguous()

  def call_device(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    """`interpolate_device` with patch tiling (all patches as one batch)."""
    if not self._tiled():
      return self.interpolate_device(x0, x1, dt)
    x0_patches = tiling.image_to_patches(x0, self._block_shape)
    x1_patches = tiling.image_to_patches(x1, self._block_shape)
    dt_patches = dt[:1].expand(x0_patches.shape[0])
    out = self.interpolate_device(x0_patches, x1_patches, dt_patches)
    return tiling.patches_to_image(out, self._block_shape)

  def _to_device(self, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        self._device)

  def interpolate(self, x0: np.ndarray, x1: np.ndarray,
                  dt: np.ndarray) -> np.ndarray:
    """Pad -> forward -> crop, numpy in and out (no patch tiling)."""
    out = self.interpolate_device(self._to_device(x0), self._to_device(x1),
                                  self._to_device(dt))
    return out.cpu().numpy()

  def __call__(self, x0: np.ndarray, x1: np.ndarray,
               dt: np.ndarray) -> np.ndarray:
    out = self.call_device(self._to_device(x0), self._to_device(x1),
                           self._to_device(dt))
    return out.cpu().numpy()
