"""Work fan-out: deterministic sharding and a local process pool.

Port of frame_interpolation_tpu/utils/fanout.py (the reference's Beam
pipelines run on the in-process DirectRunner, so their capability is
single-machine fan-out):

  * `shard(items, shard_index, num_shards)`: round-robin sharding. N hosts
    run the same CLI with `--shard_index=$i --num_shards=$N` and split the
    work with no coordinator (cli/interpolate_dir).
  * `process_map(fn, items, num_workers)`: a local process pool for
    CPU-bound work. Work bound to one GPU shards across hosts instead.
"""
from __future__ import annotations

import multiprocessing
from typing import Callable, Iterable, List, Sequence, TypeVar

T = TypeVar('T')
R = TypeVar('R')


def shard(items: Sequence[T], shard_index: int, num_shards: int) -> List[T]:
  """items[shard_index::num_shards]: across all shard indices each item is
  covered once, in order within a shard."""
  if num_shards < 1:
    raise ValueError(f'num_shards must be >= 1, got {num_shards}')
  if not 0 <= shard_index < num_shards:
    raise ValueError(
        f'shard_index {shard_index} outside [0, {num_shards})')
  return list(items[shard_index::num_shards])


def process_map(fn: Callable[[T], R], items: Iterable[T],
                num_workers: int) -> List[R]:
  """Maps `fn` over `items` with a spawn process pool, in order.

  num_workers <= 1 runs inline (no process).
  """
  items = list(items)
  if num_workers <= 1 or len(items) <= 1:
    return [fn(item) for item in items]
  context = multiprocessing.get_context('spawn')
  with context.Pool(min(num_workers, len(items))) as pool:
    return pool.map(fn, items)
