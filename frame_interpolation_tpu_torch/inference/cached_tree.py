"""The feature-cached frame tree: each frame's features extracted once.

Port of frame_interpolation_tpu/inference/cached_tree.py. The chunked tree
(inference/interpolator.expand_tree_chunked) runs the feature
extractor on both endpoints of every pair at every depth, as the
reference's recursion does (eval/util.py:62-91). Here each pair's tree is
a walk over a static midpoint DFS schedule with a stack of `times + 2`
feature slots: each input frame's (image pyramid, feature pyramid) is
extracted once, at batch 1, every midpoint reads its parents' features
from the stack, and midpoints at the final depth skip extraction (their
features feed nothing).

The JAX package runs each pair as one XLA program (`pair_body`: the
right frame's extraction, then the schedule under lax.scan with lax.cond
for the leaves), carrying the right endpoint's features to the next pair.
Here `expand_pair` is that body: the schedule is static given `times`, so
its Python stack is a fixed set of slots, and on a CUDA device the
Interpolator captures the whole body as one graph a pair shape
(`Interpolator.tree_pair_device`), replayed once per input pair. Cropping
a midpoint and padding it again with zeros reproduces the uncached path's
input exactly, so on the CPU the cached DFS equals the uncached DFS bit
for bit; against the chunked tree, which runs at other batch sizes, it
agrees to float noise.

Memory: the stack holds `times + 2` frames' features (about 0.7 GB a
1080p frame in bf16 by the JAX package's estimate), whatever the tree's
size; the finished frames are written into one output tensor. One graph
holds a whole pair's tree, so its pool holds that stack and one
midpoint's forward.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def dfs_schedule(times: int) -> Dict[str, np.ndarray]:
  """Static midpoint-DFS schedule for one pair at recursion depth `times`.

  Returns arrays of length 2^times - 1 (one entry per midpoint, in
  pre-order: parents strictly before children):

    a_slot, b_slot: stack slots holding the parent frames' features.
    m_slot: stack slot that receives the midpoint's features.
    out_pos: the midpoint's position in the pair's 2^times-frame output
      block (frame A sits at position 0; frame B belongs to the next pair).
    extract: whether the midpoint's features are needed (False exactly for
      final-depth leaves, whose features feed nothing).

  Slots are reused once a subtree completes; the peak is `times + 2`
  (endpoints + one midpoint per live recursion level).
  """
  a_slots: List[int] = []
  b_slots: List[int] = []
  m_slots: List[int] = []
  out_pos: List[int] = []
  extract: List[bool] = []
  free = list(range(2, times + 2))

  def rec(a: int, b: int, depth: int, lo: int, hi: int) -> None:
    mid = (lo + hi) // 2
    m = free.pop(0)
    a_slots.append(a)
    b_slots.append(b)
    m_slots.append(m)
    out_pos.append(mid)
    extract.append(depth > 1)
    if depth > 1:
      rec(a, m, depth - 1, lo, mid)
      rec(m, b, depth - 1, mid, hi)
    free.insert(0, m)

  if times > 0:
    rec(0, 1, times, 0, 2**times)
  return {
      'a_slot': np.asarray(a_slots, np.int32),
      'b_slot': np.asarray(b_slots, np.int32),
      'm_slot': np.asarray(m_slots, np.int32),
      'out_pos': np.asarray(out_pos, np.int32),
      'extract': np.asarray(extract, np.bool_),
  }


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
  """The io.images.to_uint8 rule on a tensor: (clip(x * 255, 0, 255) + 0.5)
  truncated to uint8 (round half up), each step one f32 rounding as numpy
  does it."""
  return (torch.clamp(x.float() * 255.0, 0.0, 255.0) + 0.5).to(torch.uint8)


def expand_pair(features_fn: Callable, midpoint_fn: Callable, left,
                right_frame: torch.Tensor, times: int):
  """One input pair's tree: the `pair_body` of the JAX package's
  expand_tree_cached_program.

  `left` holds the left frame's features; `features_fn(frame)` extracts
  `right_frame`'s (1, H, W, 3), and `midpoint_fn(f0, f1, with_features)`
  makes a midpoint (1, H, W, 3), cropped, and its features or None.
  Walks `dfs_schedule(times)` over `times + 2` feature slots and returns
  (the 2^times - 1 midpoints in time order, the right frame's features).
  """
  sched = dfs_schedule(times)
  steps = zip(*(sched[k].tolist() for k in
                ('a_slot', 'b_slot', 'm_slot', 'out_pos', 'extract')))
  right = features_fn(right_frame)
  slots = [left, right] + [None] * times
  mids = [None] * (2**times - 1)
  for a_slot, b_slot, m_slot, pos, needs_features in steps:
    mid, features = midpoint_fn(slots[a_slot], slots[b_slot],
                                with_features=needs_features)
    mids[pos - 1] = mid
    if needs_features:
      slots[m_slot] = features
  return torch.cat(mids), right


def expand_tree_cached(interpolator, frames: torch.Tensor, times: int,
                       as_uint8: bool) -> torch.Tensor:
  """Expands (N, H, W, 3) f32 `frames` on the interpolator's device to
  ((N-1)*2^T + 1, H, W, 3) in time order (uint8 when `as_uint8`).

  `interpolator` provides `features_device` and `tree_pair_device`
  (inference/interpolator.py): each input frame is extracted once, one
  frame at a time, and the right endpoint's features carry over to the
  next pair.
  """
  n = int(frames.shape[0])

  def quantize(x):
    return quantize_u8(x) if as_uint8 else x

  if times <= 0 or n < 2:
    return quantize(frames).contiguous()
  per_pair = 2**times
  out = torch.empty(((n - 1) * per_pair + 1,) + tuple(frames.shape[1:]),
                    dtype=torch.uint8 if as_uint8 else frames.dtype,
                    device=frames.device)
  out[::per_pair] = quantize(frames)
  right = interpolator.features_device(frames[:1])
  for i in range(n - 1):
    mids, right = interpolator.tree_pair_device(
        right, frames[i + 1:i + 2], times, as_uint8=as_uint8)
    out[i * per_pair + 1:(i + 1) * per_pair] = mids
  return out


def expand_tree_cached_tiled(interpolator, frames: torch.Tensor, times: int,
                             as_uint8: bool,
                             block_shape: Sequence[int]) -> torch.Tensor:
  """The cached tree under patch tiling.

  The reference tiles a frame into block_height x block_width patches and
  interpolates each patch pair on its own (eval/interpolator.py:192-206).
  Under recursion the reassemble and re-split between depths cancel, so
  the whole tree commutes with tiling: each patch's tree is expanded in
  turn (raster order) and the frames are reassembled once at the end.
  Peak feature memory is one patch's stack.
  """
  n, height, width, channels = (int(s) for s in frames.shape)
  bh, bw = block_shape
  ph, pw = height // bh, width // bw
  if height != ph * bh or width != pw * bw:
    raise ValueError(f'block_shape {tuple(block_shape)} must evenly divide '
                     f'{(height, width)}')
  # (N, H, W, C) -> (P, N, ph, pw, C), raster patch order.
  patches = frames.reshape(n, bh, ph, bw, pw, channels)
  patches = patches.permute(1, 3, 0, 2, 4, 5).reshape(bh * bw, n, ph, pw,
                                                       channels)
  out = torch.stack([
      expand_tree_cached(interpolator, patch.contiguous(), times, as_uint8)
      for patch in patches])
  # (P, M, ph, pw, C) -> (M, H, W, C).
  m = out.shape[1]
  out = out.reshape(bh, bw, m, ph, pw, channels).permute(2, 0, 3, 1, 4, 5)
  return out.reshape(m, height, width, channels)
