"""Triplet Example generation for the dataset builders (no Beam, no TF).

Port of frame_interpolation_tpu/data/builders/triplets.py (the reference's
datasets/util.py in google-research/frame-interpolation): reads three
image files, optionally center-crops them by a factor and/or downscales
them in linear light (gamma 2.2, local-mean resampling, gamma back,
util.py:33-48), and serializes a triplet Example. `run_pipeline` takes the
place of Beam's ExampleGenerator: a thread pool builds the Examples, and
they go to the TFRecord shards round-robin in input order. PIL is imported
inside the functions, so the package imports without it; the CRC of each
record comes from data/tfrecord.py (the native library where it builds).
"""
from __future__ import annotations

import concurrent.futures
import io
import logging
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import example_proto, tfrecord

_UINT8_MAX_F = 255.0
_GAMMA = 2.2


def resize_local_mean(image: np.ndarray, out_height: int,
                      out_width: int) -> np.ndarray:
  """Area-weighted (local-mean) resize, skimage.resize_local_mean parity.

  Each output pixel is the mean of the input region it covers, computed as
  two separable 1-D weighted sums built from interval overlaps.
  """

  def axis_weights(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    weights = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
      start = i * scale
      stop = (i + 1) * scale
      left = int(np.floor(start))
      right = int(np.ceil(stop))
      for j in range(left, min(right, in_size)):
        overlap = min(stop, j + 1) - max(start, j)
        if overlap > 0:
          weights[i, j] = overlap
      weights[i] /= weights[i].sum()
    return weights

  h, w = image.shape[:2]
  wy = axis_weights(h, out_height)
  wx = axis_weights(w, out_width)
  flat = image.reshape(h, -1)
  out = wy @ flat  # (out_h, w*c)
  out = out.reshape(out_height, w, -1).transpose(1, 0, 2).reshape(w, -1)
  out = wx @ out
  out = out.reshape(out_width, out_height, -1).transpose(1, 0, 2)
  return out.reshape(out_height, out_width, *image.shape[2:])


def resample_image(image: np.ndarray, width: int, height: int) -> np.ndarray:
  """Gamma-aware downscale (reference util.py:33-48): uint8 -> uint8."""
  linear = np.power(np.clip(image.astype(np.float32) / _UINT8_MAX_F, 0, 1),
                    _GAMMA)
  resized = resize_local_mean(linear, height, width)
  gamma = np.power(np.clip(resized, 0, 1), 1.0 / _GAMMA)
  return np.clip(gamma * _UINT8_MAX_F + 0.5, 0.0,
                 _UINT8_MAX_F).astype(np.uint8)


def generate_image_triplet_example(
    triplet_dict: Mapping[str, str],
    scale_factor: int = 1,
    center_crop_factor: int = 1) -> Optional[bytes]:
  """Builds one serialized triplet Example from three image filepaths.

  Center-crop first, then downscale (reference util.py:51-168).
  Unprocessed images keep their encoded bytes and format; processed ones
  are re-encoded as PNG. Returns None (and logs) when an image is missing
  or unreadable, as the reference skips it.
  """
  from PIL import Image
  if len(triplet_dict) != 3:
    raise ValueError(
        f'Length of triplet_dict must be exactly 3, not {len(triplet_dict)}.')
  if scale_factor <= 0 or center_crop_factor <= 0:
    raise ValueError(f'(scale_factor, center_crop_factor) must be positive, '
                     f'Not ({scale_factor}, {center_crop_factor}).')

  features: Dict[str, object] = {}
  mid_frame_path = os.path.dirname(triplet_dict['frame_1'])
  features['path'] = [mid_frame_path.encode()]

  for image_key, image_path in triplet_dict.items():
    if not os.path.exists(image_path):
      logging.error('File not found: %s', image_path)
      return None
    try:
      with open(image_path, 'rb') as f:
        byte_array = f.read()
      pil_image = Image.open(io.BytesIO(byte_array))
      pil_image.load()
    except (OSError, Image.UnidentifiedImageError):
      logging.exception('Cannot read image file: %s', image_path)
      return None
    width, height = pil_image.size
    image_format = (pil_image.format or 'png').lower()

    if center_crop_factor > 1:
      image = np.array(pil_image)
      quarter_height = image.shape[0] // (2 * center_crop_factor)
      quarter_width = image.shape[1] // (2 * center_crop_factor)
      image = image[quarter_height:-quarter_height,
                    quarter_width:-quarter_width, :]
      pil_image = Image.fromarray(image)
      height, width = image.shape[:2]
      byte_array, image_format = _encode_png(pil_image)
      if byte_array is None:
        return None

    if scale_factor > 1:
      image = np.array(pil_image)
      image = resample_image(image, image.shape[1] // scale_factor,
                             image.shape[0] // scale_factor)
      pil_image = Image.fromarray(image)
      height, width = image.shape[:2]
      byte_array, image_format = _encode_png(pil_image)
      if byte_array is None:
        return None

    features[f'{image_key}/encoded'] = [byte_array]
    features[f'{image_key}/format'] = [image_format.encode()]
    features[f'{image_key}/height'] = [int(height)]
    features[f'{image_key}/width'] = [int(width)]

  return example_proto.encode_example(features)


def _encode_png(pil_image) -> Tuple[Optional[bytes], Optional[str]]:
  buffer = io.BytesIO()
  try:
    pil_image.save(buffer, format='PNG')
  except OSError:
    logging.exception('Cannot encode image')
    return None, None
  return buffer.getvalue(), 'png'


def run_pipeline(triplet_dicts: Sequence[Mapping[str, str]],
                 output_path: str,
                 num_shards: int,
                 scale_factor: int = 1,
                 center_crop_factor: int = 1,
                 num_workers: int = 8) -> int:
  """Builds every triplet in a thread pool and writes sharded TFRecords
  (`<output_path>-0000i-of-0000N`).

  Takes the place of the reference's Beam DirectRunner pipeline
  (datasets/create_*_tfrecord.py). Examples go to the shards round-robin
  in input order; unreadable triplets are skipped. Returns the number of
  examples written.
  """
  writers = [
      tfrecord.TFRecordWriter(
          tfrecord.shard_filename(output_path, i, num_shards))
      for i in range(num_shards)
  ]
  written = 0
  try:
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
      futures = [
          pool.submit(generate_image_triplet_example, triplet, scale_factor,
                      center_crop_factor)
          for triplet in triplet_dicts
      ]
      for future in futures:
        example = future.result()
        if example is None:
          continue
        writers[written % num_shards].write(example)
        written += 1
  finally:
    for writer in writers:
      writer.close()
  return written
