"""Alignment padding and patch fold/unfold for high-resolution inference.

Port of frame_interpolation_tpu/ops/tiling.py on NHWC tensors:
`pad_to_align` centre-pads H and W up to a multiple of `align` and returns
the crop box that undoes it; `image_to_patches` folds a (1, H, W, C) image
into (bh*bw, H/bh, W/bw, C) raster-order patches, which then run as one
batch; `patches_to_image` is its exact inverse.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def pad_to_align(x: torch.Tensor, align: int) -> Tuple[torch.Tensor, Dict]:
  """Zero-pads H and W (offset pad // 2) to divide `align`.

  Returns (padded, crop_box) with crop_box the keyword arguments of
  `crop_to_bounding_box`.
  """
  if x.dim() != 4:
    raise ValueError(f'expected (B, H, W, C); got {tuple(x.shape)}')
  if align <= 0:
    raise ValueError('align must be a positive number.')
  height, width = x.shape[1], x.shape[2]
  height_to_pad = (align - height % align) if height % align else 0
  width_to_pad = (align - width % align) if width % align else 0
  top = height_to_pad // 2
  left = width_to_pad // 2
  padded = F.pad(x, (0, 0, left, width_to_pad - left,
                     top, height_to_pad - top))
  bbox_to_crop = {
      'offset_height': top,
      'offset_width': left,
      'target_height': height,
      'target_width': width,
  }
  return padded, bbox_to_crop


def crop_to_bounding_box(image: torch.Tensor, offset_height: int,
                         offset_width: int, target_height: int,
                         target_width: int) -> torch.Tensor:
  """tf.image.crop_to_bounding_box on (..., H, W, C)."""
  return image[..., offset_height:offset_height + target_height,
               offset_width:offset_width + target_width, :]


def image_to_patches(image: torch.Tensor, block_shape) -> torch.Tensor:
  """Folds (1, H, W, C) into (bh*bw, H/bh, W/bw, C) raster-order patches."""
  block_height, block_width = block_shape
  batch, height, width, channel = image.shape
  if batch != 1:
    raise ValueError('patch folding is defined for batch-1 images.')
  patch_height, patch_width = height // block_height, width // block_width
  if height != patch_height * block_height:
    raise ValueError(f'block_height={block_height} should evenly divide '
                     f'height={height}.')
  if width != patch_width * block_width:
    raise ValueError(f'block_width={block_width} should evenly divide '
                     f'width={width}.')
  x = image.reshape(block_height, patch_height, block_width, patch_width,
                    channel)
  x = x.permute(0, 2, 1, 3, 4)
  return x.reshape(block_height * block_width, patch_height, patch_width,
                   channel)


def patches_to_image(patches: torch.Tensor, block_shape) -> torch.Tensor:
  """Inverse of `image_to_patches`: (bh*bw, ph, pw, C) -> (1, H, W, C)."""
  block_height, block_width = block_shape
  num, patch_height, patch_width, channel = patches.shape
  if num != block_height * block_width:
    raise ValueError(f'{num} patches do not form a {block_height}x'
                     f'{block_width} grid.')
  x = patches.reshape(block_height, block_width, patch_height, patch_width,
                      channel)
  x = x.permute(0, 2, 1, 3, 4)
  return x.reshape(1, block_height * patch_height, block_width * patch_width,
                   channel)
