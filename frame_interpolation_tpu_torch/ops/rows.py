"""One shard's view of a row-sharded forward: which levels split, and halos.

Counterpart of the rows-SPMD context of the JAX package (ops/warp.py
spmd_rows_mesh, read by warp_window.backward_warp_window_rows and
conv_stack.stack_rows) and of the halo exchanges that GSPMD inserts around
the convs, pools and resizes of a row-sharded forward there.
parallel/inference.SpatialShardedInterpolator runs one shard of the model
per thread, each on its slab of the frame's rows, with that shard's
`RowShard` installed for the thread (`sharding`); the ops that reach
across rows read it through `current()`:

  * models/layers.Conv: a k x k SAME conv takes its missing rows from the
    neighbouring slabs (zeros beyond the frame, as SAME pads); a split
    conv's pieces take theirs in one exchange;
  * ops/resize: a 2x upsample takes one row on each side (the edge row
    again beyond the frame, as the resize clamps);
  * ops/pyramid.avg_pool_2x and the extractor's fused pool stay local on
    even slabs;
  * ops/warp.backward_warp: the row-mode warp (backward_warp_rows);
  * ops/conv_stack.stack_rows: the extractor's two convs on a 2-row halo.

A pyramid level splits when its global rows divide into even slabs, one
per shard (the fused pool's row pairs then never straddle two shards). A
level that does not split is gathered whole and runs on every shard; a
split level below it takes its own rows back out of the whole plane. The
split levels are the finest ones: a level splits only if the level above
it does. Rows never split columns, and each level halves the width, so a
tensor's width names its level.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Tuple

import torch

_LOCAL = threading.local()


def current() -> Optional['RowShard']:
  """The RowShard installed for this thread, or None outside a shard."""
  return getattr(_LOCAL, 'shard', None)


@contextlib.contextmanager
def sharding(shard: 'RowShard') -> Iterator['RowShard']:
  """Installs `shard` for the calling thread while the block runs."""
  saved = current()
  _LOCAL.shard = shard
  try:
    yield shard
  finally:
    _LOCAL.shard = saved


def level_heights(height: int, width: int) -> List[Tuple[int, int]]:
  """(width, height) of every pyramid level below a (height, width) frame,
  finest first: each level is the 2x2 pool of the one above, extents
  floored."""
  levels = []
  while height >= 1 and width >= 1:
    levels.append((width, height))
    height, width = height // 2, width // 2
  return levels


def splits(height: int, n: int) -> bool:
  """Whether a level of `height` global rows splits over `n` shards."""
  return height % n == 0 and (height // n) % 2 == 0


class RowShard:
  """Shard `index` of `collective.n` shards of a frame of (height, width).

  `collective` exchanges one value among the shards
  (parallel/shard_map.Collective); every shard must make the same
  exchanges in the same order.
  """

  def __init__(self, collective, index: int, height: int, width: int):
    self.collective = collective
    self.index = index
    self.n = collective.n
    self._levels = {}
    above = True
    for w, h in level_heights(height, width):
      above = above and splits(h, self.n)
      self._levels[w] = (h, above)

  def _level(self, width: int) -> Tuple[int, bool]:
    try:
      return self._levels[width]
    except KeyError:
      raise ValueError(f'no pyramid level of width {width} under this '
                       f'row-sharded frame') from None

  def height(self, width: int) -> int:
    """The global rows of the level of this width."""
    return self._level(width)[0]

  def split_width(self, width: int) -> bool:
    return self._level(width)[1]

  def split(self, x: torch.Tensor) -> bool:
    """Whether NHWC `x` is this shard's slab of a split level (else it is
    the whole plane, the same on every shard)."""
    return self.split_width(x.shape[2])

  def take(self, x: torch.Tensor) -> torch.Tensor:
    """This shard's rows of a whole plane at a split level."""
    slab = x.shape[1] // self.n
    return x[:, self.index * slab:(self.index + 1) * slab]

  def exchange(self, value):
    return self.collective.exchange(self.index, value)

  def gather(self, x: torch.Tensor) -> torch.Tensor:
    """The whole plane from every shard's slab, on this shard's device."""
    return torch.cat([s.to(x.device) for s in self.exchange(x)], dim=1)

  def pmax(self, value: float) -> float:
    """The largest of the shards' values (NaN if any is NaN), the same on
    every shard."""
    values = self.exchange(float(value))
    return float('nan') if any(v != v for v in values) else max(values)

  def halo(self, x, above: int, below: int, edge: str = 'zeros'):
    """This shard's slab with `above` rows before it and `below` after it
    from the other shards' slabs, in one exchange. Rows beyond the frame
    are zeros (`edge='zeros'`, SAME padding) or the frame's edge row
    (`edge='clamp'`). `x` may be a list of slabs of one level (a split
    conv's pieces): they share the one exchange, and the list of their
    extended slabs comes back."""
    if isinstance(x, torch.Tensor):
      return self._extend(x, self.exchange(x), above, below, edge)
    pieces = list(x)
    slabs = self.exchange(pieces)
    return [self._extend(p, [s[j] for s in slabs], above, below, edge)
            for j, p in enumerate(pieces)]

  def _extend(self, x: torch.Tensor, slabs: List[torch.Tensor], above: int,
              below: int, edge: str) -> torch.Tensor:
    slab = x.shape[1]
    height = slab * self.n
    lo = self.index * slab - above
    hi = (self.index + 1) * slab + below
    parts = []
    if lo < 0:
      parts.append(self._beyond(slabs[0][:, :1], -lo, edge, x.device))
    for i in range(max(lo, 0) // slab, (min(hi, height) - 1) // slab + 1):
      start, stop = max(lo - i * slab, 0), min(hi - i * slab, slab)
      piece = x if i == self.index else slabs[i]
      parts.append(piece[:, start:stop].to(x.device))
    if hi > height:
      parts.append(self._beyond(slabs[-1][:, -1:], hi - height, edge,
                                x.device))
    return torch.cat(parts, dim=1)

  @staticmethod
  def _beyond(edge_row: torch.Tensor, rows: int, edge: str,
              device) -> torch.Tensor:
    edge_row = edge_row.to(device)
    if edge == 'zeros':
      edge_row = torch.zeros_like(edge_row)
    elif edge != 'clamp':
      raise ValueError(f'edge must be zeros or clamp; got {edge!r}')
    return edge_row.expand(-1, rows, -1, -1)

  def settle(self, x: torch.Tensor) -> torch.Tensor:
    """A slab pooled from a split level: kept where its own level splits,
    else gathered whole."""
    return x if self.split(x) else self.gather(x)
