"""Sharded serving over a device mesh: patches, tree nodes and rows.

Port of frame_interpolation_tpu/parallel/inference.py. Each class runs
one shard per device of a `mesh.Mesh` in a thread of its own
(a shard_map.ShardPool), each shard with its device's replica of the
model:

  * ShardedInterpolator: the patches of a tiled pair, split over the
    shards (no exchange between them);
  * ShardedVideoInterpolator: each depth's chunk of tree nodes of the
    chunked frame tree, split over the shards (no exchange between them);
    a drop-in for Interpolator in the frontier drivers of
    inference/recursion.py;
  * SpatialShardedInterpolator: one full-frame forward, its rows split
    over the shards (ops/rows.py): convs, pools and resizes exchange
    halos, the warp runs in row mode (ops/warp.backward_warp_rows, the
    kernel's fi_warp_rows_*), the extractor's convs run their kernel on
    halo'd slabs (ops/conv_stack.stack_rows), and levels whose rows do not
    split run whole on every shard. The output is the full-frame forward's.

A mesh may repeat a device: on one card, `[cuda:0] * 4` runs every
exchange and every row-mode kernel there. Shards on one card share its
stream, so they run in turn; on a host with N cards the same code runs a
shard on each. Only shards that share one card have been run here.
Inference only, as in JAX.

Captured programs (utils/programs.py), as the JAX package jits each of
these: the patch- and tree-sharded classes replay each shard's pair
program from its thread. The row-sharded pair is one program on a mesh
that repeats one card: its shards' threads launch onto the program's
capturing stream, so the whole sharded forward, every shard and every
exchange, is one CUDA graph and a call is one replay. The exchanges meet
at the host barrier only while the graph is captured; in the graph they
are the stream's order. Nothing in the forward reads the device on the
host (the row-mode warp reads the slabs where they lie: ops/warp.py
backward_warp_rows).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..inference import interpolator as interpolator_lib
from ..inference.interpolator import Interpolator
from ..ops import rows, tiling
from ..options import Options
from ..utils import programs
from . import mesh as mesh_lib
from .shard_map import Collective, ShardPool


def _shard_interpolators(params_or_model: Any, options: Options,
                         mesh: mesh_lib.Mesh, align: Optional[int],
                         graphs: Optional[bool]) -> List[Interpolator]:
  """One Interpolator per shard, over its device's replica; the shards on
  one device share one pool for their graphs (their replays run in turn
  on the device's stream anyway)."""
  model = interpolator_lib.as_model(params_or_model, options)
  pools = {device: programs.Pool() for device in mesh.devices}
  return [Interpolator(replica, options, align=align, device=device,
                       graphs=graphs, pool=pools[device])
          for replica, device in zip(mesh_lib.replicate(model, mesh),
                                     mesh.devices)]


class _Sharded:
  """What the three classes share: the mesh and one Interpolator a shard.

  `graphs` is the shards' Interpolators' (None: captured programs on a
  CUDA device): each shard replays its own pair program from its thread.
  """

  def __init__(self, params_or_model: Any, options: Options,
               mesh: mesh_lib.Mesh, align: Optional[int],
               graphs: Optional[bool] = None):
    self._mesh = mesh
    self._align = align or None
    self._shards = _shard_interpolators(params_or_model, options, mesh,
                                        align, graphs)
    self._pool = ShardPool(mesh.devices)

  @property
  def num_devices(self) -> int:
    return self._mesh.size

  @property
  def device(self) -> torch.device:
    """Where inputs gather and outputs return: the first shard's device."""
    return self._mesh.devices[0]

  def to_device(self, x: Any) -> torch.Tensor:
    return self._shards[0].to_device(x)

  def _forward_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                     dt: torch.Tensor) -> torch.Tensor:
    """Pad -> forward -> crop of a batch whose size divides the mesh, each
    shard taking its part; the outputs in order on `device`."""
    parts0 = mesh_lib.shard_batch(x0, self._mesh)
    parts1 = mesh_lib.shard_batch(x1, self._mesh)
    parts_dt = mesh_lib.shard_batch(dt, self._mesh)
    outs = self._pool.run(
        lambda i: self._shards[i].interpolate_device(parts0[i], parts1[i],
                                                     parts_dt[i]))
    return torch.cat([o.to(self.device) for o in outs])


class ShardedInterpolator(_Sharded):
  """Patch-tiled interpolation with the patches split over a mesh.

  Usage:
    mesh = parallel.create_mesh()
    interp = ShardedInterpolator(model, options, mesh, block_shape=(4, 4))
    mid = interp(x0, x1, dt)      # (1, H, W, 3) numpy in and out

  The patch batch is padded with copies of its last patch to a multiple
  of the mesh; each patch is the tiled Interpolator's.
  """

  def __init__(self, params_or_model: Any, options: Options,
               mesh: mesh_lib.Mesh, block_shape: Sequence[int],
               align: Optional[int] = 64, graphs: Optional[bool] = None):
    super().__init__(params_or_model, options, mesh, align, graphs)
    self._block_shape = tuple(block_shape)

  def call_device(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    p0 = tiling.image_to_patches(x0, self._block_shape)
    p1 = tiling.image_to_patches(x1, self._block_shape)
    count = p0.shape[0]
    pad = -count % self.num_devices
    if pad:
      p0 = torch.cat([p0, p0[-1:].expand(pad, *p0.shape[1:])])
      p1 = torch.cat([p1, p1[-1:].expand(pad, *p1.shape[1:])])
    time = dt.reshape(-1)[:1].expand(count + pad).contiguous()
    with torch.inference_mode():
      out = self._forward_batch(p0, p1, time)[:count]
      return tiling.patches_to_image(out, self._block_shape)

  def __call__(self, x0: np.ndarray, x1: np.ndarray,
               dt: np.ndarray) -> np.ndarray:
    """Interpolates one (1, H, W, 3) pair by mesh-sharded patches."""
    out = self.call_device(self.to_device(x0), self.to_device(x1),
                           self.to_device(dt))
    return out.cpu().numpy()


class ShardedVideoInterpolator(_Sharded):
  """The chunked frame tree with each chunk's nodes split over a mesh.

  A tree depth's pairs are independent, so each forward chunk (a multiple
  of the mesh, one node a shard by default) splits over the shards with
  no exchange between them. Exposes the Interpolator's
  `expand_tree_device` contract (and `device`, `to_device`) for the
  frontier drivers of inference/recursion.py, with the chunked tree's
  outputs.
  """

  def __init__(self, params_or_model: Any, options: Options,
               mesh: mesh_lib.Mesh, align: Optional[int] = 64,
               graphs: Optional[bool] = None):
    super().__init__(params_or_model, options, mesh, align, graphs)

  def expand_tree_device(self, frames: Any, times_to_interpolate: int,
                         max_batch: Optional[int] = None,
                         as_uint8: bool = False) -> torch.Tensor:
    """(N, H, W, 3) frames, numpy or tensor, f32 or uint8, to
    ((N-1)*2^T + 1, H, W, 3) on `device`; see Interpolator. Each depth's
    pairs run in batches of `max_batch` (default: one a shard), rounded
    up to a multiple of the mesh."""
    frames = self.to_device(frames)
    n = self.num_devices
    max_batch = -(-(max_batch or n) // n) * n
    with torch.inference_mode():
      return interpolator_lib.expand_tree_chunked(
          frames, times_to_interpolate, max_batch, as_uint8,
          self._forward_batch, batch_quantum=n)


class SpatialShardedInterpolator(_Sharded):
  """One full frame interpolated across a mesh by rows.

  Each shard runs the model on its slab of the padded frame's rows with
  its ops/rows.RowShard installed; the shards' output slabs, gathered,
  are the full-frame forward's. A frame whose rows do not split into even
  slabs runs whole on every shard.

  `graphs` (None: on a mesh whose shards all lie on one CUDA device): the
  whole sharded pair (pad, every shard's forward, the gather, the crop) as
  one captured program a key, keyed like the Interpolator's pair. Its
  shards' threads launch onto the capturing stream, which only shards on
  the capturing device share, so a mesh of several cards runs eagerly
  (graphs=True raises there), as does the CPU.
  """

  def __init__(self, params_or_model: Any, options: Options,
               mesh: mesh_lib.Mesh, align: Optional[int] = 64,
               graphs: Optional[bool] = None):
    # The shards' models run inside this class's program, not their own.
    super().__init__(params_or_model, options, mesh, align, graphs=False)
    device = mesh.devices[0]
    one_device = all(d == device for d in mesh.devices)
    if graphs and device.type == 'cuda' and not one_device:
      raise ValueError(f'SpatialShardedInterpolator: graphs=True needs a '
                       f'mesh on one CUDA device (its shards launch onto '
                       f'one capturing stream); got {mesh!r}')
    self._program = None
    if programs.resolve(graphs, device, 'SpatialShardedInterpolator') and (
        one_device):
      self._program = programs.Program(programs.weak_method(self._pair_eager),
                                       device, 'row_pair')

  @property
  def program(self) -> Optional[programs.Program]:
    """The captured row-sharded pair, or None on the eager path."""
    return self._program

  def call_device(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) f32 frames on any device to the midpoint on `device`:
    one replay a call on the graphs' path."""
    with torch.inference_mode():
      if self._program is None:
        return self._pair_eager(x0, x1, dt)
      return self._program(x0, x1, dt)

  def _pair_eager(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    time = dt.reshape(-1, 1).float()
    bbox = None
    if self._align is not None:
      x0, bbox = tiling.pad_to_align(x0, self._align)
      x1, _ = tiling.pad_to_align(x1, self._align)
    height, width = x0.shape[1], x0.shape[2]
    split = rows.splits(height, self.num_devices)
    collective = Collective(self.num_devices)

    def shard(index: int) -> torch.Tensor:
      row_shard = rows.RowShard(collective, index, height, width)
      a, b = x0, x1
      if split:
        a, b = row_shard.take(x0), row_shard.take(x1)
      device = self._mesh.devices[index]
      with rows.sharding(row_shard):
        return self._shards[index].model(
            a.to(device), b.to(device), time.to(device))['image']

    outs = self._pool.run(shard, collective)
    if split:
      image = torch.cat([o.to(self.device) for o in outs], dim=1)
    else:
      image = outs[0]
    if bbox is not None:
      image = tiling.crop_to_bounding_box(image, **bbox)
    return image.contiguous()

  def __call__(self, x0: np.ndarray, x1: np.ndarray,
               dt: np.ndarray) -> np.ndarray:
    """Interpolates (B, H, W, 3) pairs with rows sharded over the mesh."""
    out = self.call_device(self.to_device(x0), self.to_device(x1),
                           self.to_device(dt))
    return out.cpu().numpy()
