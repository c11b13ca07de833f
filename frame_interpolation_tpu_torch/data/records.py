"""Triplet record schema: frame triplets as tf.train.Examples.

Port of frame_interpolation_tpu/data/records.py, with PIL imported inside
the functions (as io/images.py does), so the package imports without it.
Schema parity with the reference (training/data_lib.py:23-53 and
datasets/util.py:140-168 in google-research/frame-interpolation):

  frame_{0,1,2}/encoded   bytes   (PNG or JPEG)
  frame_{0,1,2}/format    bytes   ('png' | 'jpg')
  frame_{0,1,2}/height    int64
  frame_{0,1,2}/width     int64
  path                    bytes   (example id, the mid-frame's directory)

Decoding gives the training example {'x0', 'y', 'x1', 'time'} with float32
[0, 1] RGB frames; frame_1 (the temporal midpoint) is the ground truth 'y'
and time is fixed at 0.5 (data_lib.py:56-82).
"""
from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np

from ..io import images as images_io
from . import example_proto


def encode_image(image_uint8: np.ndarray, image_format: str = 'png') -> bytes:
  from PIL import Image
  buf = io.BytesIO()
  fmt = 'JPEG' if image_format in ('jpg', 'jpeg') else 'PNG'
  Image.fromarray(image_uint8).save(buf, format=fmt)
  return buf.getvalue()


def decode_image(data: bytes) -> np.ndarray:
  """Decodes to float32 [0,1] RGB (H, W, 3)."""
  from PIL import Image
  with Image.open(io.BytesIO(data)) as img:
    arr = np.asarray(img.convert('RGB'), dtype=np.float32)
  return arr / 255.0


def make_triplet_example(frames, path: str = '',
                         image_format: str = 'png') -> bytes:
  """Serializes three uint8 (or float [0,1]) RGB frames into an Example."""
  features: Dict[str, object] = {'path': [path.encode()]}
  for i, frame in enumerate(frames):
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
      frame = images_io.to_uint8(frame)
    height, width = frame.shape[:2]
    features[f'frame_{i}/encoded'] = [encode_image(frame, image_format)]
    features[f'frame_{i}/format'] = [image_format.encode()]
    features[f'frame_{i}/height'] = [int(height)]
    features[f'frame_{i}/width'] = [int(width)]
  return example_proto.encode_example(features)


def parse_triplet_example(record: bytes,
                          with_path: bool = False
                          ) -> Optional[Dict[str, object]]:
  """Parses a triplet record into {'x0', 'y', 'x1', 'time'[, 'path']}.

  Returns None if the record is missing frames (the reference skips
  unreadable examples, datasets/util.py:89-107).
  """
  features = example_proto.decode_example(record)
  frames = []
  for i in range(3):
    key = f'frame_{i}/encoded'
    if key not in features or not features[key]:
      return None
    frames.append(decode_image(features[key][0]))
  example: Dict[str, object] = {
      'x0': frames[0],
      'y': frames[1],
      'x1': frames[2],
      'time': np.float32(0.5),
  }
  if with_path:
    path = features.get('path', [b''])
    example['path'] = path[0].decode() if path else ''
  return example
