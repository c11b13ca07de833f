"""Image resizing with TF2 `tf.image.resize` semantics, on NHWC tensors.

Port of frame_interpolation_tpu/ops/resize.py: half-pixel centres, no
antialiasing. The flow upsampling (bilinear, exactly 2x on the model's
path) and the fusion decoder's nearest upsampling use it.
"""
from __future__ import annotations

import numpy as np
import torch


def _linear_interp_tables(in_size: int, out_size: int):
  """TF2 half-pixel bilinear tables for one axis (lower, upper, lerp)."""
  scale = in_size / out_size
  x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
  floor = np.floor(x)
  lower = np.maximum(floor.astype(np.int64), 0)
  upper = np.minimum(np.ceil(x).astype(np.int64), in_size - 1)
  lerp = (x - floor).astype(np.float32)
  return lower, upper, lerp


def _nearest_index_table(in_size: int, out_size: int) -> np.ndarray:
  """TF2 half-pixel nearest-neighbour index table for one axis."""
  scale = in_size / out_size
  idx = np.floor((np.arange(out_size, dtype=np.float64) + 0.5) * scale)
  return np.clip(idx.astype(np.int64), 0, in_size - 1)


def _resample_axis_linear(x: torch.Tensor, dim: int,
                          out_size: int) -> torch.Tensor:
  lower, upper, lerp = _linear_interp_tables(x.shape[dim], out_size)
  lo = x.index_select(dim, torch.from_numpy(lower).to(x.device))
  up = x.index_select(dim, torch.from_numpy(upper).to(x.device))
  shape = [1] * x.dim()
  shape[dim] = out_size
  w = torch.from_numpy(lerp).to(x.device).reshape(shape)
  return lo * (1.0 - w) + up * w


def _upsample2x_axis_linear(x: torch.Tensor, dim: int) -> torch.Tensor:
  """Exact-2x bilinear along one axis: out[2i] = .25 in[i-1] + .75 in[i],
  out[2i+1] = .75 in[i] + .25 in[i+1], with edge-clamped neighbours."""
  n = x.shape[dim]
  prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
  nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
  even = 0.25 * prev + 0.75 * x
  odd = 0.75 * x + 0.25 * nxt
  shape = list(x.shape)
  shape[dim] *= 2
  return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def resize_bilinear(image: torch.Tensor, size) -> torch.Tensor:
  """`tf.image.resize(images, size)` (bilinear, half-pixel, no antialias).

  image: (B, H, W, C). Returns float32, as TF does.
  """
  new_h, new_w = int(size[0]), int(size[1])
  h, w = image.shape[1], image.shape[2]
  x = image.float()
  if (h, w) == (new_h, new_w):
    return x
  if new_h == 2 * h and new_w == 2 * w:
    return _upsample2x_axis_linear(_upsample2x_axis_linear(x, 1), 2)
  return _resample_axis_linear(_resample_axis_linear(x, 1, new_h), 2, new_w)


def resize_nearest(image: torch.Tensor, size) -> torch.Tensor:
  """`tf.image.resize(images, size, method=NEAREST)`; keeps the dtype."""
  new_h, new_w = int(size[0]), int(size[1])
  h, w = image.shape[1], image.shape[2]
  if (h, w) == (new_h, new_w):
    return image
  if new_h == 2 * h and new_w == 2 * w:
    return image.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
  hi = torch.from_numpy(_nearest_index_table(h, new_h)).to(image.device)
  wi = torch.from_numpy(_nearest_index_table(w, new_w)).to(image.device)
  return image.index_select(1, hi).index_select(2, wi)
