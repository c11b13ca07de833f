"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

Port of frame_interpolation_tpu/utils/tensorboard.py. The reference logs
training/eval scalars, images, and histograms through tf.summary
(training/train_lib.py:103-111, 254-269 and training/eval_lib.py:99-131 in
google-research/frame-interpolation). This module writes the same
`events.out.tfevents.*` files directly: an event file is a TFRecord stream
of serialized `tensorflow.Event` protos, encoded with the same hand-rolled
wire-format helpers as the Example codec.

Supported summary kinds (all the reference uses):
  * scalar     — Event.summary.value{tag, simple_value}
  * image      — value{tag, image{height, width, colorspace, png bytes}}
  * histogram  — value{tag, histo{min,max,num,sum,sum_squares,limits,counts}}

Event files written here read back through the JAX package's TFRecord
reader and Example codec (tests/test_torch_data.py).
"""
from __future__ import annotations

import os
import struct
import time
from typing import Optional, Sequence

import numpy as np

from ..data import tfrecord
from ..data.example_proto import _len_delimited, _tag, _varint
from ..data.records import encode_image
from ..io import images as images_io


def _double_field(field: int, value: float) -> bytes:
  return _tag(field, 1) + struct.pack('<d', value)


def _float_field(field: int, value: float) -> bytes:
  return _tag(field, 5) + struct.pack('<f', value)


def _varint_field(field: int, value: int) -> bytes:
  return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _packed_doubles(field: int, values: Sequence[float]) -> bytes:
  payload = b''.join(struct.pack('<d', v) for v in values)
  return _len_delimited(field, payload)


class SummaryWriter:
  """Writes TensorBoard event files; API shaped like tf.summary writers."""

  def __init__(self, logdir: str, filename_suffix: str = ''):
    os.makedirs(logdir, exist_ok=True)
    base = (f'events.out.tfevents.{int(time.time())}.{os.uname().nodename}.'
            f'{os.getpid()}')
    path = os.path.join(logdir, base + filename_suffix)
    # A second writer of the same process within the same second (a resumed
    # run) gets its own file instead of truncating the first one's.
    count = 0
    while os.path.exists(path):
      count += 1
      path = os.path.join(logdir, f'{base}.{count}{filename_suffix}')
    self._writer = tfrecord.TFRecordWriter(path)
    # First record: file_version event (TensorBoard expects it).
    self._write_event(_double_field(1, time.time()) +
                      _len_delimited(3, b'brain.Event:2'))

  def _write_event(self, event_payload: bytes) -> None:
    self._writer.write(event_payload)

  def _summary_event(self, step: int, value_msg: bytes) -> None:
    event = (_double_field(1, time.time()) +      # wall_time
             _varint_field(2, int(step)) +        # step
             _len_delimited(5, _len_delimited(1, value_msg)))  # summary.value
    self._write_event(event)

  def scalar(self, tag: str, value: float, step: int) -> None:
    value_msg = (_len_delimited(1, tag.encode()) +
                 _float_field(2, float(value)))
    self._summary_event(step, value_msg)

  def image(self, tag: str, image: np.ndarray, step: int) -> None:
    """Logs a float [0,1] (H, W, C) or (1, H, W, C) image as PNG."""
    image = np.asarray(image)
    if image.ndim == 4:
      image = image[0]
    height, width = image.shape[:2]
    channels = image.shape[2] if image.ndim == 3 else 1
    png = encode_image(images_io.to_uint8(image))
    image_msg = (_varint_field(1, height) + _varint_field(2, width) +
                 _varint_field(3, channels) + _len_delimited(4, png))
    value_msg = (_len_delimited(1, tag.encode()) +
                 _len_delimited(4, image_msg))
    self._summary_event(step, value_msg)

  def histogram(self, tag: str, values, step: int,
                bins: int = 30) -> None:
    data = np.asarray(values, np.float64).reshape(-1)
    if data.size == 0:
      return
    counts, edges = np.histogram(data, bins=bins)
    # HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    #                 bucket_limit=6 (packed double) bucket=7 (packed double)
    histo = (_double_field(1, float(data.min())) +
             _double_field(2, float(data.max())) +
             _double_field(3, float(data.size)) +
             _double_field(4, float(data.sum())) +
             _double_field(5, float(np.square(data).sum())) +
             _packed_doubles(6, edges[1:].tolist()) +
             _packed_doubles(7, counts.astype(np.float64).tolist()))
    value_msg = (_len_delimited(1, tag.encode()) +
                 _len_delimited(5, histo))
    self._summary_event(step, value_msg)

  def flush(self) -> None:
    self._writer.flush()

  def close(self) -> None:
    self._writer.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class NoOpWriter:
  """Drop-in writer that discards everything (summaries disabled)."""

  def scalar(self, *a, **k):
    pass

  def image(self, *a, **k):
    pass

  def histogram(self, *a, **k):
    pass

  def flush(self):
    pass

  def close(self):
    pass


def create_writer(logdir: Optional[str]) -> object:
  return SummaryWriter(logdir) if logdir else NoOpWriter()
