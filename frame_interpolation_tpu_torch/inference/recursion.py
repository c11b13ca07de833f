"""Recursive midpoint interpolation drivers.

Port of frame_interpolation_tpu/inference/recursion.py (reference
semantics: eval/util.py:62-153 in google-research/frame-interpolation):
given frames [f_0 .. f_{n-1}] and `times_to_interpolate` = T, emit, in time
order, every input frame plus 2^T - 1 midpoints between each consecutive
pair: (n-1) * 2^T + 1 frames.

  * `interpolate_recursively` (and `_from_files`): the reference's in-order
    DFS, one batch-1 forward per midpoint.
  * `interpolate_recursively_cached`: the same order, each frame's features
    extracted once (Interpolator.features_device).
  * `interpolate_frontier`: the whole tree as one `expand_tree_device`
    call (the Interpolator's feature-cached DFS, or the chunked tree of
    parallel/inference.ShardedVideoInterpolator), one fetch.
  * `interpolate_frontier_streaming`: the same over chunks of consecutive
    pairs, with device memory bounded whatever the sequence's length; the
    fetch of a chunk overlaps the compute of the next ones. Under a
    profiler (utils/profiling.span) each chunk's host work is an
    `fi.chunk` span and each wait for a fetched chunk an `fi.fetch_wait`
    span; neither is open while a frame is yielded.
"""
from __future__ import annotations

import collections
import os
from typing import (Any, Callable, Generator, Iterable, List, Optional,
                    Sequence)

import numpy as np
import torch

from ..io import images
from ..utils import profiling
from .interpolator import Interpolator

ProgressFn = Callable[[int], None]


def _host_f32(f) -> np.ndarray:
  """Host-side image normalization: uint8 -> f32/255, floats unchanged."""
  f = np.asarray(f)
  return f.astype(np.float32) / 255.0 if f.dtype == np.uint8 else f


def _recursive_generator(
    frame1: np.ndarray, frame2: np.ndarray, num_recursions: int,
    interpolator: Interpolator,
    progress: Optional[ProgressFn] = None
) -> Generator[np.ndarray, None, None]:
  """In-order DFS: yields frame1 and all midpoints, excluding frame2."""
  if num_recursions == 0:
    yield frame1
    return
  time = np.full((1,), 0.5, dtype=np.float32)
  mid_frame = interpolator(frame1[np.newaxis, ...], frame2[np.newaxis, ...],
                           time)[0]
  if progress is not None:
    progress(1)
  yield from _recursive_generator(frame1, mid_frame, num_recursions - 1,
                                  interpolator, progress)
  yield from _recursive_generator(mid_frame, frame2, num_recursions - 1,
                                  interpolator, progress)


def interpolate_recursively(
    frames: Sequence[np.ndarray], times_to_interpolate: int,
    interpolator: Interpolator,
    progress: Optional[ProgressFn] = None) -> Iterable[np.ndarray]:
  """The reference's streaming driver (eval/util.py:125-153)."""
  n = len(frames)
  for i in range(1, n):
    yield from _recursive_generator(frames[i - 1], frames[i],
                                    times_to_interpolate, interpolator,
                                    progress)
  yield frames[-1]


def interpolate_recursively_from_files(
    frame_paths: Sequence[str], times_to_interpolate: int,
    interpolator: Interpolator,
    progress: Optional[ProgressFn] = None) -> Iterable[np.ndarray]:
  """The streaming driver over files, loaded on demand (eval/util.py:94-123):
  at most one input pair in host memory at a time."""
  n = len(frame_paths)
  for i in range(1, n):
    yield from _recursive_generator(images.read_image(frame_paths[i - 1]),
                                    images.read_image(frame_paths[i]),
                                    times_to_interpolate, interpolator,
                                    progress)
  yield images.read_image(frame_paths[-1])


def interpolate_recursively_cached(
    frames: Sequence[Any], times_to_interpolate: int,
    interpolator: Interpolator,
    progress: Optional[ProgressFn] = None,
    as_uint8: bool = False) -> Generator[np.ndarray, None, None]:
  """The in-order DFS with each frame's features computed once.

  `frames` may be arrays or file paths (loaded lazily, one pair at a
  time). The outputs and their order are `interpolate_recursively`'s;
  features stay on the device along the DFS path only, so peak feature
  memory is T + 2 frames whatever the sequence's length.
  """

  def load(frame):
    if isinstance(frame, (str, os.PathLike)):
      return images.read_image(os.fspath(frame))
    return _host_f32(frame).astype(np.float32)

  def emit_host(frame):
    # Input frames stay on the host; they take the same writers' rule the
    # device applies to midpoints.
    return images.to_uint8(frame) if as_uint8 else frame

  if len(frames) < 2 or times_to_interpolate <= 0:
    for frame in frames:
      yield emit_host(load(frame))
    return
  first = load(frames[0])
  orig_hw = first.shape[0], first.shape[1]

  def features(frame):
    return interpolator.features_device(frame[np.newaxis])

  def recurse(frame1, feat1, frame2, feat2, depth):
    if depth == 0:
      yield frame1
      return
    mid_dev, mid_feat = interpolator.midpoint_from_features_device(
        feat1, feat2, orig_hw, as_uint8=as_uint8, with_features=depth > 1)
    mid = mid_dev[0].cpu().numpy()
    if progress is not None:
      progress(1)
    yield from recurse(frame1, feat1, mid, mid_feat, depth - 1)
    yield from recurse(mid, mid_feat, frame2, feat2, depth - 1)

  # Frames are only yielded (the compute runs on features), so the input
  # frames can be quantized on the host; midpoints arrive quantized.
  right = first
  right_feat = features(first)
  for i in range(1, len(frames)):
    left, left_feat = emit_host(right), right_feat
    right = load(frames[i])
    right_feat = features(right)
    yield from recurse(left, left_feat, right, right_feat,
                       times_to_interpolate)
  yield emit_host(right)


def num_output_frames(num_inputs: int, times_to_interpolate: int) -> int:
  """(n-1) * 2^T + 1: total frames emitted, inputs included."""
  return (num_inputs - 1) * 2**times_to_interpolate + 1


def num_interpolated_frames(num_inputs: int, times_to_interpolate: int) -> int:
  """(n-1) * (2^T - 1): midpoints only, as the reference's tqdm total."""
  return (num_inputs - 1) * (2**times_to_interpolate - 1)


def frontier_pairs_per_chunk(frame_nbytes: int, times_to_interpolate: int,
                             memory_budget_bytes: int) -> int:
  """Input pairs whose expanded trees fit the device budget.

  A chunk holds pairs * 2^T + 1 frames on the device. The estimate carries
  a x3 factor for the expansion's transient copies (the chunked tree's
  last depth holds the sequence, the midpoints and the merged stack in f32
  at once); the streaming driver splits the budget between the chunks in
  flight.
  """
  expansion_overhead = 3
  tree = max(1, frame_nbytes) * 2**times_to_interpolate * expansion_overhead
  return max(1, (memory_budget_bytes - frame_nbytes) // tree)


def _stack_inputs(frames: Sequence[Any]) -> np.ndarray:
  """All-uint8 frames stack as uint8 (they cross to the device as bytes
  and convert there exactly); mixed dtypes normalize on the host first,
  as np.stack would promote uint8 frames at 0-255 scale into f32."""
  arrays = [np.asarray(f) for f in frames]
  if all(a.dtype == np.uint8 for a in arrays):
    return np.stack(arrays)
  return np.stack([_host_f32(a).astype(np.float32) for a in arrays])


class _Fetch:
  """A device tensor's copy into pinned host memory on a side stream.

  On one stream, a copy of chunk k issued after chunk k+1's launches would
  wait for chunk k+1. So an event is recorded after chunk k's launches,
  the side stream waits for that event alone and copies, and the host
  synchronises only on the copy. On the CPU the tensor is the result.
  """

  def __init__(self, tensor: torch.Tensor,
               stream: Optional['torch.cuda.Stream']):
    if stream is None:
      self._host, self._done = tensor, None
      return
    computed = torch.cuda.Event()
    computed.record()
    self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                             pin_memory=True)
    with torch.cuda.stream(stream):
      stream.wait_event(computed)
      self._host.copy_(tensor, non_blocking=True)
      # The allocator may hand the tensor's memory out again only after
      # the side stream's copy.
      tensor.record_stream(stream)
      self._done = torch.cuda.Event()
      self._done.record(stream)

  def result(self) -> np.ndarray:
    if self._done is not None:
      self._done.synchronize()
    return self._host.numpy()


def _fetch_stream(interpolator: Interpolator):
  if interpolator.device.type != 'cuda':
    return None
  return torch.cuda.Stream(device=interpolator.device)


def interpolate_frontier_streaming(
    frames: Sequence, times_to_interpolate: int,
    interpolator: Interpolator,
    max_batch: int = 8,
    pairs_per_chunk: Optional[int] = None,
    memory_budget_bytes: int = 4 << 30,
    progress: Optional[ProgressFn] = None,
    as_uint8: bool = False,
    pipeline_depth: int = 2
) -> Generator[np.ndarray, None, None]:
  """The frame tree over chunks of consecutive pairs, streamed in order.

  Outputs equal `interpolate_frontier` on the whole sequence, but the
  device holds (pairs_per_chunk * 2^T + 1) frames a chunk, whatever the
  sequence's length.

  Args:
    frames: (H, W, 3) float32 or uint8 arrays, or file paths (read as
      uint8, lazily, one chunk at a time).
    times_to_interpolate: recursion depth T.
    interpolator: the model wrapper.
    max_batch: the batch cap of ShardedVideoInterpolator's chunked tree
      (the Interpolator's cached tree runs one pair at a time).
    pairs_per_chunk: input pairs a chunk; by default sized from
      `memory_budget_bytes`.
    memory_budget_bytes: device budget for the frame trees, from which the
      default `pairs_per_chunk` comes (the model's workspace is outside it).
    progress: called with the number of frames just produced.
    as_uint8: quantize on the device with the writers' exact rule before
      the fetch, a quarter of the device-to-host volume.
    pipeline_depth: chunks computed ahead of the fetch (>= 1); the memory
      budget is split depth + 1 ways.

  Yields:
    (n-1) * 2^T + 1 frames in time order, inputs included.
  """

  def load(frame):
    if isinstance(frame, (str, os.PathLike)):
      return images.read_image_uint8(os.fspath(frame))
    return frame

  def emit(frame):
    if as_uint8:
      return images.to_uint8(frame)
    return _host_f32(frame)

  n = len(frames)
  if n == 0:
    return
  first = load(frames[0])
  if n < 2 or times_to_interpolate <= 0:
    yield emit(first)
    for frame in frames[1:]:
      yield emit(load(frame))
    return
  pipeline_depth = max(1, int(pipeline_depth))
  if pairs_per_chunk is None:
    # The device tree is f32 whatever the inputs' dtype.
    pairs_per_chunk = frontier_pairs_per_chunk(
        int(np.asarray(first).size) * 4, times_to_interpolate,
        memory_budget_bytes // (pipeline_depth + 1))

  def chunks():
    boundary = first
    for start in range(0, n - 1, pairs_per_chunk):
      stop = min(start + pairs_per_chunk, n - 1)
      chunk = [boundary] + [load(f) for f in frames[start + 1:stop + 1]]
      yield chunk, stop == n - 1
      boundary = chunk[-1]

  # Chunks consume only input frames, so they are independent: the fetch
  # of chunk k runs while chunks k+1 .. k+depth compute.
  stream = _fetch_stream(interpolator)
  pending = collections.deque()  # (fetch, is_last, n_chunk_inputs)
  for chunk, last in chunks():
    with profiling.span('fi.chunk'):
      out = interpolator.expand_tree_device(
          _stack_inputs(chunk), times_to_interpolate, max_batch=max_batch,
          as_uint8=as_uint8)
      pending.append((_Fetch(out, stream), last, len(chunk)))
      del out
    if len(pending) > pipeline_depth:
      yield from _fetched_frames(*pending.popleft(), progress)
  while pending:
    yield from _fetched_frames(*pending.popleft(), progress)


def _fetched_frames(fetch: _Fetch, last: bool, n_chunk_inputs: int,
                    progress: Optional[ProgressFn]
                    ) -> Generator[np.ndarray, None, None]:
  """One expanded chunk's frames in time order. The final frame is dropped
  unless `last`: it is the next chunk's first input, which that chunk
  emits again."""
  with profiling.span('fi.fetch_wait'):
    stacked = fetch.result()
  if progress is not None:
    progress(stacked.shape[0] - n_chunk_inputs)
  stop = stacked.shape[0] if last else stacked.shape[0] - 1
  for i in range(stop):
    yield stacked[i]


def interpolate_frontier(
    frames: Sequence[np.ndarray], times_to_interpolate: int,
    interpolator: Interpolator,
    max_batch: int = 8,
    progress: Optional[ProgressFn] = None,
    as_uint8: bool = False) -> List[np.ndarray]:
  """The whole tree on the device, then one fetch.

  Args:
    frames: input frames, each (H, W, 3) float32 in [0, 1] or uint8.
    times_to_interpolate: recursion depth T; 2^T - 1 midpoints per pair.
    interpolator: the model wrapper.
    max_batch: the batch cap of ShardedVideoInterpolator's chunked tree
      (the Interpolator's cached tree runs one pair at a time).
    progress: called with the number of frames just produced.
    as_uint8: quantize on the device with io.images.to_uint8's exact rule
      before the fetch: the same written PNG/mp4 bytes at a quarter of the
      device-to-host volume.

  Returns:
    The full time-ordered frame list, (n-1) * 2^T + 1 frames.
  """
  if len(frames) < 2 or times_to_interpolate <= 0:
    return ([images.to_uint8(f) for f in frames] if as_uint8
            else [_host_f32(f) for f in frames])
  out = interpolator.expand_tree_device(
      _stack_inputs(frames), times_to_interpolate, max_batch=max_batch,
      as_uint8=as_uint8)
  stacked = out.cpu().numpy()
  if progress is not None:
    progress(stacked.shape[0] - len(frames))
  return [stacked[i] for i in range(stacked.shape[0])]
