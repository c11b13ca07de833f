"""Serving predictor: one-call image or video interpolation.

Port of frame_interpolation_tpu/serving/predictor.py (the reference's
Replicate/cog entry point, predict.py:15-88, without cog):
`Predictor.setup()` loads the model once; `predict()` takes two frame paths
and returns the t=0.5 mid-frame PNG (times_to_interpolate=1) or a 30-fps
video of 2^T + 1 frames. Inputs of different sizes are cropped to their
common top-left region, as the reference does.

The model path is a bundle, the port's (options.json + state_dict.pt) or
the JAX package's (options.json + params.msgpack); a TF release converts
into the latter with the JAX package's cli/build_params. The device
defaults to cuda and raises without a GPU.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional, Sequence

import numpy as np

_INPUT_EXT = ('.png', '.jpg', '.jpeg')


class Predictor:
  """Load-once, call-many serving wrapper around the Interpolator."""

  def __init__(self, model_path: str,
               align: Optional[int] = 64,
               block_shape: Optional[Sequence[int]] = None,
               dtype_policy: Optional[str] = None,
               device: Any = 'cuda'):
    self._model_path = model_path
    self._align = align
    self._block_shape = block_shape
    self._dtype_policy = dtype_policy
    self._device = device
    self.interpolator = None
    self.batch_dt = np.full((1,), 0.5, dtype=np.float32)

  def setup(self) -> None:
    """Loads the weights; call once before predict()."""
    from ..inference import load_interpolator
    self.interpolator = load_interpolator(
        self._model_path, align=self._align, block_shape=self._block_shape,
        dtype_policy=self._dtype_policy, device=self._device)

  def _load_pair(self, frame1: str, frame2: str):
    from ..io import images
    ext1 = os.path.splitext(str(frame1))[-1].lower()
    ext2 = os.path.splitext(str(frame2))[-1].lower()
    if ext1 not in _INPUT_EXT or ext2 not in _INPUT_EXT:
      raise ValueError('Please provide png, jpg or jpeg images.')
    image_1 = images.read_image(str(frame1))
    image_2 = images.read_image(str(frame2))
    if image_1.shape != image_2.shape:
      height = min(image_1.shape[0], image_2.shape[0])
      width = min(image_1.shape[1], image_2.shape[1])
      image_1 = image_1[:height, :width]
      image_2 = image_2[:height, :width]
    return image_1, image_2

  def predict(self, frame1: str, frame2: str,
              times_to_interpolate: int = 1,
              fps: int = 30,
              output_dir: Optional[str] = None) -> str:
    """Returns the path of the generated PNG (T=1) or MP4 (T>1)."""
    if not 1 <= times_to_interpolate <= 8:
      raise ValueError('times_to_interpolate must be in [1, 8].')
    from ..io import images, video
    image_1, image_2 = self._load_pair(frame1, frame2)
    if times_to_interpolate > 1:
      video.get_ffmpeg_path()  # fail before the model runs
    if self.interpolator is None:
      self.setup()
    out_dir = output_dir or tempfile.mkdtemp()

    if times_to_interpolate == 1:
      mid = self.interpolator(image_1[np.newaxis], image_2[np.newaxis],
                              self.batch_dt)[0]
      out_path = os.path.join(out_dir, 'out.png')
      images.write_image(out_path, mid)
      return out_path

    from ..inference import recursion
    # as_uint8: write_video quantizes anyway; the device applies the same
    # rule and the fetch is a quarter of the f32 one.
    frames = recursion.interpolate_frontier(
        [image_1, image_2], times_to_interpolate, self.interpolator,
        as_uint8=True)
    out_path = os.path.join(out_dir, 'out.mp4')
    video.write_video(out_path, frames, fps=fps)
    return out_path
