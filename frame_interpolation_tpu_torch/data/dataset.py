"""Host-side input pipelines for training and evaluation.

Port of frame_interpolation_tpu/data/dataset.py, with the same semantics as
the reference's tf.data pipeline (training/data_lib.py:186-296 in
google-research/frame-interpolation):

  * training: shard interleave, shuffle, joint random crop across
    (x0, x1, y), repeat, fixed batch size, prefetch; several
    (files, crop_size) sources mixed by sampling.
  * eval: deterministic shard order, batch size 1, optional
    `take(max_examples)`, name-keyed dataset dict.

Decode and crop run on host threads; batches are numpy dicts, and the
training loop moves them to the device, where the random augmentations run
(data/augmentations.py).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import records, tfrecord


def _iter_shards_forever(paths: Sequence[str], rng: np.random.RandomState,
                         shuffle: bool) -> Iterator[str]:
  while True:
    order = list(paths)
    if shuffle:
      rng.shuffle(order)
    yield from order


def _joint_random_crop(example: Dict[str, np.ndarray], crop_size: int,
                       rng: np.random.RandomState) -> Optional[Dict]:
  """Crops x0/x1/y at one common random offset (data_lib.py:85-119)."""
  if crop_size <= 0:
    return example
  height, width = example['y'].shape[:2]
  if height < crop_size or width < crop_size:
    return None
  top = rng.randint(0, height - crop_size + 1)
  left = rng.randint(0, width - crop_size + 1)
  out = dict(example)
  for key in ('x0', 'x1', 'y'):
    out[key] = example[key][top:top + crop_size, left:left + crop_size]
  return out


class TrainingSource:
  """One (sharded file, crop_size) training source."""

  def __init__(self, file: str, crop_size: int):
    self.paths = tfrecord.sharded_filenames(file)
    self.crop_size = crop_size


def _training_example_stream(source: TrainingSource, seed: int,
                             shuffle_buffer: int) -> Iterator[Dict]:
  rng = np.random.RandomState(seed)
  buffer: List[Dict] = []
  for shard in _iter_shards_forever(source.paths, rng, shuffle=True):
    for record in tfrecord.read_records(shard, validate=False):
      example = records.parse_triplet_example(record)
      if example is None:
        continue
      example = _joint_random_crop(example, source.crop_size, rng)
      if example is None:
        continue
      if len(buffer) < shuffle_buffer:
        buffer.append(example)
        continue
      index = rng.randint(0, len(buffer))
      buffer[index], example = example, buffer[index]
      yield example


def _threaded_example_stream(source: TrainingSource, seed: int,
                             shuffle_buffer: int,
                             num_threads: int) -> Iterator[Dict]:
  """Merges `num_threads` decode workers into one example stream.

  Each worker walks its own shard permutation (tf.data interleave
  semantics with cycle_length=num_threads); PNG/JPEG decode releases the
  GIL in PIL, so workers overlap decode with device compute.
  """
  if num_threads <= 1:
    return _training_example_stream(source, seed, shuffle_buffer)
  q: 'queue.Queue' = queue.Queue(maxsize=4 * num_threads)

  def worker(worker_seed):
    for example in _training_example_stream(source, worker_seed,
                                            shuffle_buffer):
      q.put(example)

  for i in range(num_threads):
    threading.Thread(target=worker, args=(seed + 7919 * i,),
                     daemon=True).start()

  def drain():
    while True:
      yield q.get()

  return drain()


def create_training_iterator(
    sources: Sequence[TrainingSource],
    batch_size: int,
    weights: Optional[Sequence[float]] = None,
    seed: int = 0,
    shuffle_buffer: int = 256,
    prefetch: int = 2,
    num_threads: int = 1) -> Iterator[Dict[str, np.ndarray]]:
  """Infinite batched training iterator mixing several sources.

  Mirrors `create_training_dataset` (data_lib.py:213-259): when several
  (files, crop_sizes) sources are given they are sampled per example with
  the given weights (uniform by default). `num_threads` decode workers run
  per source.
  """
  if not sources:
    raise ValueError('need at least one training source')
  rng = np.random.RandomState(seed + 991)
  streams = [
      _threaded_example_stream(s, seed + 7 * i, shuffle_buffer, num_threads)
      for i, s in enumerate(sources)
  ]
  probs = None
  if weights is not None:
    total = float(sum(weights))
    probs = [w / total for w in weights]

  def make_batches() -> Iterator[Dict[str, np.ndarray]]:
    while True:
      examples = []
      for _ in range(batch_size):
        index = rng.choice(len(streams), p=probs)
        examples.append(next(streams[index]))
      yield {
          'x0': np.stack([e['x0'] for e in examples]),
          'x1': np.stack([e['x1'] for e in examples]),
          'y': np.stack([e['y'] for e in examples]),
          'time': np.full((batch_size, 1), 0.5, np.float32),
      }

  return _prefetch_iterator(make_batches(), prefetch)


def _prefetch_iterator(it: Iterator, depth: int) -> Iterator:
  """Runs `it` on a daemon thread with a bounded queue (tf.data prefetch)."""
  if depth <= 0:
    return it
  q: 'queue.Queue' = queue.Queue(maxsize=depth)
  sentinel = object()

  def worker():
    try:
      for item in it:
        q.put(item)
    finally:
      q.put(sentinel)

  thread = threading.Thread(target=worker, daemon=True)
  thread.start()

  def drain():
    while True:
      item = q.get()
      if item is sentinel:
        return
      yield item

  return drain()


def eval_dataset(file: str,
                 batch_size: int = 1,
                 max_examples: int = -1,
                 with_path: bool = True) -> Iterator[Dict[str, np.ndarray]]:
  """Deterministic eval iterator over one sharded file (batch 1 default).

  Matches `create_eval_datasets` semantics (data_lib.py:263-296):
  deterministic order, full frames (no crop), `take(max_examples)`.
  """
  count = 0
  batch: List[Dict] = []
  for record in tfrecord.read_sharded(file, validate=False):
    if max_examples is not None and max_examples >= 0:
      if count >= max_examples:
        break
    example = records.parse_triplet_example(record, with_path=with_path)
    if example is None:
      continue
    count += 1
    batch.append(example)
    if len(batch) == batch_size:
      yield _stack_eval_batch(batch, with_path)
      batch = []
  if batch:
    yield _stack_eval_batch(batch, with_path)


def _stack_eval_batch(batch: List[Dict], with_path: bool) -> Dict:
  out = {
      'x0': np.stack([e['x0'] for e in batch]),
      'x1': np.stack([e['x1'] for e in batch]),
      'y': np.stack([e['y'] for e in batch]),
      'time': np.full((len(batch), 1), 0.5, np.float32),
  }
  if with_path:
    out['path'] = [e.get('path', '') for e in batch]
  return out


def create_eval_datasets(files: Sequence[str], names: Sequence[str],
                         batch_size: int = 1, max_examples: int = -1
                         ) -> Dict[str, 'EvalDataset']:
  """Name-keyed dict of re-iterable eval datasets."""
  return {
      name: EvalDataset(file, batch_size, max_examples)
      for name, file in zip(names, files)
  }


class EvalDataset:
  """Re-iterable deterministic eval dataset."""

  def __init__(self, file: str, batch_size: int = 1, max_examples: int = -1):
    self.file = file
    self.batch_size = batch_size
    self.max_examples = max_examples

  def __iter__(self):
    return eval_dataset(self.file, self.batch_size, self.max_examples)
