"""Video writing through an ffmpeg pipe (host side).

Port of frame_interpolation_tpu/io/video.py (the reference writes
`interpolated.mp4` with mediapy, ffmpeg underneath). Frames go to ffmpeg as
raw RGB, one at a time; without ffmpeg `get_ffmpeg_path()` raises a clear
error.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Iterable

import numpy as np

from . import images

_FFMPEG = 'ffmpeg'


def get_ffmpeg_path() -> str:
  path = shutil.which(_FFMPEG)
  if not path:
    raise RuntimeError(
        f"Program '{_FFMPEG}' is not found; perhaps install ffmpeg using "
        "'apt-get install ffmpeg'.")
  return path


def have_ffmpeg() -> bool:
  return shutil.which(_FFMPEG) is not None


def write_video(filename: str, frames: Iterable[np.ndarray],
                fps: float = 30.0) -> None:
  """Writes float [0,1] (or uint8) RGB frames to an H.264 mp4.

  `frames` may be a generator: frames stream to ffmpeg one at a time, so a
  long video never sits in host memory whole.
  """
  iterator = iter(frames)
  try:
    first = next(iterator)
  except StopIteration:
    raise ValueError('write_video called with no frames.') from None
  height, width = first.shape[:2]
  cmd = [
      get_ffmpeg_path(), '-y', '-f', 'rawvideo', '-pix_fmt', 'rgb24',
      '-s', f'{width}x{height}', '-r', str(fps), '-i', '-',
      '-an', '-vcodec', 'libx264', '-pix_fmt', 'yuv420p',
      '-crf', '18', filename
  ]
  proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
  try:
    proc.stdin.write(images.to_uint8(first).tobytes())
    for frame in iterator:
      proc.stdin.write(images.to_uint8(frame).tobytes())
  finally:
    proc.stdin.close()
    ret = proc.wait()
  if ret != 0:
    raise RuntimeError(f'ffmpeg exited with status {ret}')
