"""Image resizing with TF2 `tf.image.resize` semantics, on NHWC tensors.

Port of frame_interpolation_tpu/ops/resize.py: half-pixel centres, no
antialiasing. The flow upsampling (bilinear, exactly 2x on the model's
path) and the fusion decoder's nearest upsampling use it.

Inside a shard of a row-sharded forward (ops/rows.py), an upsample to a
split level gives this shard's rows. From a split level, the rows double
exactly: the bilinear takes one row from each neighbouring slab (the
frame's edge row again beyond it, as the resize clamps) and the nearest
none; from a level that does not split, the whole plane is resized and
the shard takes its rows. The arithmetic of each output row is the whole
frame's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rows

# (table, in_size, out_size, device) -> the table on the device. Built on
# the host once and kept: a captured graph (utils/programs.py) may read an
# entry by address, and a host-to-device copy cannot be captured. The
# sizes a model meets are few, and each table is one row of indices.
_DEVICE_TABLES = {}


def _device_table(kind: str, in_size: int, out_size: int,
                  device: torch.device) -> torch.Tensor:
  key = (kind, in_size, out_size, device)
  table = _DEVICE_TABLES.get(key)
  if table is None:
    if kind == 'nearest':
      host = _nearest_index_table(in_size, out_size)
    else:
      host = _linear_interp_tables(in_size, out_size)[
          ('lower', 'upper', 'lerp').index(kind)]
    table = _DEVICE_TABLES.setdefault(key, torch.from_numpy(host).to(device))
  return table


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
  in_size = x.shape[dim]
  lo = x.index_select(dim, _device_table('lower', in_size, out_size,
                                         x.device))
  up = x.index_select(dim, _device_table('upper', in_size, out_size,
                                         x.device))
  shape = [1] * x.dim()
  shape[dim] = out_size
  w = _device_table('lerp', in_size, out_size, x.device).reshape(shape)
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


def _resize_bilinear_whole(x: torch.Tensor, new_h: int,
                           new_w: int) -> torch.Tensor:
  h, w = x.shape[1], x.shape[2]
  if (h, w) == (new_h, new_w):
    return x
  if new_h == 2 * h and new_w == 2 * w:
    return _upsample2x_axis_linear(_upsample2x_axis_linear(x, 1), 2)
  return _resample_axis_linear(_resample_axis_linear(x, 1, new_h), 2, new_w)


def _resize_nearest_whole(image: torch.Tensor, new_h: int,
                          new_w: int) -> torch.Tensor:
  h, w = image.shape[1], image.shape[2]
  if (h, w) == (new_h, new_w):
    return image
  if new_h == 2 * h and new_w == 2 * w:
    return image.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
  hi = _device_table('nearest', h, new_h, image.device)
  wi = _device_table('nearest', w, new_w, image.device)
  return image.index_select(1, hi).index_select(2, wi)


def _sharded(image: torch.Tensor, new_w: int, shard, whole, rows_2x,
             cols):
  """This shard's rows of `whole(image, H, new_w)`, the resize to a split
  level of H global rows. A slab of a split level doubles its rows by
  `rows_2x(slab, shard)` and resizes its columns by `cols(x, new_w)`:
  rows double exactly between split levels, and each element's arithmetic
  is the whole frame's (the general tables give the 2x weights 0.25 and
  0.75, and the nearest's index i // 2)."""
  if not shard.split(image):
    return shard.take(whole(image, shard.height(new_w), new_w))
  if image.shape[2] == new_w:
    return image
  return cols(rows_2x(image, shard), new_w)


def _bilinear_rows_2x(slab: torch.Tensor, shard) -> torch.Tensor:
  ext = shard.halo(slab, 1, 1, edge='clamp')
  return _upsample2x_axis_linear(ext, 1)[:, 2:2 + 2 * slab.shape[1]]


def _bilinear_cols(x: torch.Tensor, new_w: int) -> torch.Tensor:
  if new_w == 2 * x.shape[2]:
    return _upsample2x_axis_linear(x, 2)
  return _resample_axis_linear(x, 2, new_w)


def _nearest_cols(x: torch.Tensor, new_w: int) -> torch.Tensor:
  if new_w == 2 * x.shape[2]:
    return x.repeat_interleave(2, dim=2)
  wi = _device_table('nearest', x.shape[2], new_w, x.device)
  return x.index_select(2, wi)


def _sharding_to(size):
  """The installed RowShard if `size` is a split level's slab, else None."""
  shard = rows.current()
  if shard is not None and shard.split_width(int(size[1])):
    return shard
  return None


def resize_bilinear(image: torch.Tensor, size) -> torch.Tensor:
  """`tf.image.resize(images, size)` (bilinear, half-pixel, no antialias).

  image: (B, H, W, C). Returns float32, as TF does.
  """
  shard = _sharding_to(size)
  if shard is not None:
    return _sharded(image.float(), int(size[1]), shard,
                    _resize_bilinear_whole, _bilinear_rows_2x,
                    _bilinear_cols)
  return _resize_bilinear_whole(image.float(), int(size[0]), int(size[1]))


def resize_nearest(image: torch.Tensor, size) -> torch.Tensor:
  """`tf.image.resize(images, size, method=NEAREST)`; keeps the dtype."""
  shard = _sharding_to(size)
  if shard is not None:
    return _sharded(image, int(size[1]), shard, _resize_nearest_whole,
                    lambda slab, _: slab.repeat_interleave(2, dim=1),
                    _nearest_cols)
  return _resize_nearest_whole(image, int(size[0]), int(size[1]))
