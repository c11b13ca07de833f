"""A thin cog (Replicate) adapter over serving.predictor.Predictor.

Port of frame_interpolation_tpu/serving/cog_predict.py (the reference's
predict.py:15-88 and cog.yaml). All logic lives in the cog-free
`Predictor`; this module only maps cog's typed IO onto it, so it imports
only where cog is installed (inside the container `cog build` makes from
serving/cog.yaml).

The model path and the dtype policy come from the environment, so one
image serves any bundle of the port:
  FI_MODEL_PATH    (default /src/pretrained_models/film_net_style)
  FI_DTYPE_POLICY  (default bfloat16, the serving policy)
"""
from __future__ import annotations

import os
from pathlib import Path

from cog import BasePredictor, Input  # requires the cog runtime

from .predictor import Predictor


class CogPredictor(BasePredictor):
  """cog entry point (serving/cog.yaml: `predict:` points here)."""

  def setup(self) -> None:
    self._predictor = Predictor(
        os.environ.get('FI_MODEL_PATH',
                       '/src/pretrained_models/film_net_style'),
        dtype_policy=os.environ.get('FI_DTYPE_POLICY', 'bfloat16'))
    self._predictor.setup()

  def predict(
      self,
      frame1: Path = Input(description='The first input frame'),
      frame2: Path = Input(description='The second input frame'),
      times_to_interpolate: int = Input(
          default=1, ge=1, le=8,
          description='1 returns the t=0.5 mid-frame PNG; >1 returns a '
                      '30-fps video with 2^times_to_interpolate + 1 '
                      'frames.'),
  ) -> Path:
    return Path(self._predictor.predict(
        str(frame1), str(frame2),
        times_to_interpolate=int(times_to_interpolate)))
