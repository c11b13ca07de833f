"""Host-side image I/O with the reference's numerics (PIL, imported lazily).

Port of frame_interpolation_tpu/io/images.py:
  * read: decode to 3-channel RGB, float32 in [0, 1] (value / 255), or the
    raw uint8 bytes for the device's own exact conversion;
  * write: clip(image * 255, 0, 255) + 0.5, truncated to uint8 (round half
    up), as PNG or, by extension, JPEG.
PIL is imported inside the functions, so the package imports without it.
"""
from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np

_UINT8_MAX_F = 255.0
# PNGs in the wild (the reference's photos/ among them) carry very large
# text chunks; PIL refuses them under its default cap.
_MAX_TEXT_CHUNK = 64 * 1024 * 1024


def _pil_image():
  from PIL import Image, PngImagePlugin
  PngImagePlugin.MAX_TEXT_CHUNK = max(PngImagePlugin.MAX_TEXT_CHUNK,
                                      _MAX_TEXT_CHUNK)
  return Image


def read_image(filename: str) -> np.ndarray:
  """Reads an sRGB 8-bit image into a float32 [0,1] RGB array (H, W, 3)."""
  with _pil_image().open(filename) as img:
    arr = np.asarray(img.convert('RGB'), dtype=np.float32)
  return arr / _UINT8_MAX_F


def read_image_uint8(filename: str) -> np.ndarray:
  """Reads an sRGB 8-bit image as raw (H, W, 3) uint8.

  The Interpolator's device conversion of these bytes equals `read_image`
  bit for bit, at a quarter of the host-to-device volume.
  """
  with _pil_image().open(filename) as img:
    return np.asarray(img.convert('RGB'), dtype=np.uint8)


def to_uint8(image: np.ndarray) -> np.ndarray:
  """Float [0,1] -> uint8 with round-half-up; uint8 passes unchanged."""
  image = np.asarray(image)
  if image.dtype == np.uint8:
    return image
  clipped = np.clip(image.astype(np.float32) * _UINT8_MAX_F, 0.0,
                    _UINT8_MAX_F)
  return (clipped + 0.5).astype(np.uint8)


def write_image(filename: str, image: np.ndarray) -> None:
  """Writes a float32 [0,1] RGB array as PNG (or JPEG for .jpg/.jpeg)."""
  directory = os.path.dirname(filename)
  if directory:
    os.makedirs(directory, exist_ok=True)
  img = _pil_image().fromarray(to_uint8(image))
  if os.path.splitext(filename)[1].lower() in ('.jpg', '.jpeg'):
    img.save(filename, format='JPEG', quality=95)
  else:
    img.save(filename, format='PNG')


def natural_sort(names: Sequence[str]) -> List[str]:
  """Natural (human) sort: frame_2 < frame_10."""

  def key(name):
    return [int(p) if p.isdigit() else p for p in re.split(r'(\d+)', name)]

  return sorted(names, key=key)
