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

The backward is deterministic (torch.use_deterministic_algorithms passes):
the exact-2x nearest is a broadcast, and the tables' selections sum each
input's cotangents in output order (`_TableSelect`).
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
    base = kind.replace('_spread', '')
    if base == 'nearest':
      host = _nearest_index_table(in_size, out_size)
    else:
      host = _linear_interp_tables(in_size, out_size)[
          ('lower', 'upper', 'lerp').index(base)]
    if kind.endswith('_spread'):
      host = _spread_tables(host, in_size)
    table = _DEVICE_TABLES.setdefault(key, torch.from_numpy(host).to(device))
  return table


def _spread_tables(table: np.ndarray, in_size: int) -> np.ndarray:
  """For a nondecreasing table of input indices (one per output), the
  outputs that read each input: (m, in_size) output indices, the r-th
  output that reads input i in row r, or -1 past input i's count."""
  counts = np.bincount(table, minlength=in_size)
  first = np.searchsorted(table, np.arange(in_size))
  spread = np.full((max(int(counts.max()), 1), in_size), -1, np.int64)
  for r in range(spread.shape[0]):
    spread[r] = np.where(r < counts, first + r, -1)
  return spread


class _TableSelect(torch.autograd.Function):
  """`x.index_select(dim, table)` for a resize's nondecreasing table, with
  a backward that sums each input's cotangents in output order by
  gathers (index_select's own backward adds them with atomics, in an
  order that changes from run to run, and raises under
  torch.use_deterministic_algorithms)."""

  @staticmethod
  def forward(ctx, x, dim, table, spread):
    ctx.dim = dim
    ctx.save_for_backward(spread)
    return x.index_select(dim, table)

  @staticmethod
  def backward(ctx, grad):
    spread, = ctx.saved_tensors
    dim = ctx.dim
    shape = [1] * grad.dim()
    shape[dim] = spread.shape[1]
    out = None
    for row in spread:
      taken = grad.index_select(dim, row.clamp_min(0))
      taken = torch.where((row >= 0).reshape(shape), taken,
                          torch.zeros((), dtype=grad.dtype,
                                      device=grad.device))
      out = taken if out is None else out + taken
    return out, None, None, None


def _table_select(x: torch.Tensor, dim: int, kind: str,
                  out_size: int) -> torch.Tensor:
  """`x`'s entries along `dim` by the resize table `kind` to `out_size`."""
  in_size = x.shape[dim]
  table = _device_table(kind, in_size, out_size, x.device)
  if not x.requires_grad:
    return x.index_select(dim, table)
  spread = _device_table(kind + '_spread', in_size, out_size, x.device)
  return _TableSelect.apply(x, dim, table, spread)


def _repeat2(x: torch.Tensor, dim: int) -> torch.Tensor:
  """Each entry along `dim` twice: the exact-2x nearest (index i // 2),
  by a broadcast whose backward is a sum (no scatter)."""
  shape = list(x.shape)
  shape.insert(dim + 1, 2)
  return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


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
  lo = _table_select(x, dim, 'lower', out_size)
  up = _table_select(x, dim, 'upper', out_size)
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
    return _repeat2(_repeat2(image, 1), 2)
  return _table_select(_table_select(image, 1, 'nearest', new_h), 2,
                       'nearest', new_w)


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
    return _repeat2(x, 2)
  return _table_select(x, 2, 'nearest', new_w)


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
                    lambda slab, _: _repeat2(slab, 1),
                    _nearest_cols)
  return _resize_nearest_whole(image, int(size[0]), int(size[1]))
