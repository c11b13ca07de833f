"""Experiment configurations mirroring the released gin files 1:1.

Port of frame_interpolation_tpu/training/configs/__init__.py, value for
value. The reference configures experiments with gin
(training/config/film_net-{L1,VGG,Style}.gin and eval/config/*.gin in
google-research/frame-interpolation). Here the same content lives in
dataclasses; every released hyperparameter is kept verbatim for checkpoint
parity. The VGG and Style presets need the MatConvNet VGG-19 weights
(`vgg_model_file`, losses/vgg19.py). gin_compat reads the reference's gin
files into these dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ...losses import PiecewiseConstantSchedule, constant_schedule
from ...options import Options


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
  """gin `training_dataset.*` / `eval_datasets.*` parity.

  `file`/`crop_size` configure one source; `files`/`crop_sizes` (+ optional
  sampling `weights`) configure several mixed sources, like the reference's
  training_dataset.files (training/data_lib.py:242-259).
  """
  file: str = ''
  batch_size: int = 8
  crop_size: int = 256
  files: Tuple[str, ...] = ()
  crop_sizes: Tuple[int, ...] = ()
  weights: Tuple[float, ...] = ()
  eval_files: Tuple[str, ...] = ()
  eval_names: Tuple[str, ...] = ()
  eval_batch_size: int = 1
  eval_max_examples: int = -1


@dataclasses.dataclass(frozen=True)
class LossSpec:
  names: Tuple[str, ...] = ('l1',)
  weight_schedules: Tuple[PiecewiseConstantSchedule, ...] = (
      constant_schedule(1.0),)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  """One training experiment: model + schedule + data + losses + aug."""
  name: str = 'film_net-L1'
  model: Options = dataclasses.field(
      default_factory=Options.film_net_released)
  learning_rate: float = 1e-4
  learning_rate_decay_steps: int = 750000
  learning_rate_decay_rate: float = 0.464158
  learning_rate_staircase: bool = True
  num_steps: int = 3000000
  dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
  training_losses: LossSpec = dataclasses.field(default_factory=LossSpec)
  test_losses: LossSpec = dataclasses.field(default_factory=lambda: LossSpec(
      names=('l1', 'psnr', 'ssim'),
      weight_schedules=(constant_schedule(1.0),) * 3))
  augmentations: Tuple[str, ...] = ('random_image_rot90', 'random_flip',
                                    'random_rotate', 'random_reverse')
  vgg_model_file: Optional[str] = None


def film_net_l1(**overrides) -> ExperimentConfig:
  """training/config/film_net-L1.gin."""
  return ExperimentConfig(name='film_net-L1', **overrides)


def film_net_vgg(vgg_model_file: str, **overrides) -> ExperimentConfig:
  """training/config/film_net-VGG.gin: l1 + vgg; vgg 1.0 -> 0.25 @ 1.5M."""
  return ExperimentConfig(
      name='film_net-VGG',
      training_losses=LossSpec(
          names=('l1', 'vgg'),
          weight_schedules=(
              PiecewiseConstantSchedule((0,), (1.0, 1.0)),
              PiecewiseConstantSchedule((1500000,), (1.0, 0.25)),
          )),
      vgg_model_file=vgg_model_file,
      **overrides)


def film_net_style(vgg_model_file: str, **overrides) -> ExperimentConfig:
  """training/config/film_net-Style.gin: l1 + vgg + style; at 1.5M steps
  vgg 1.0 -> 0.25 and style 0.0 -> 40.0 (gin lines 51-60)."""
  return ExperimentConfig(
      name='film_net-Style',
      training_losses=LossSpec(
          names=('l1', 'vgg', 'style'),
          weight_schedules=(
              PiecewiseConstantSchedule((0,), (1.0, 1.0)),
              PiecewiseConstantSchedule((1500000,), (1.0, 0.25)),
              PiecewiseConstantSchedule((1500000,), (0.0, 40.0)),
          )),
      vgg_model_file=vgg_model_file,
      **overrides)


_PRESETS = {
    'film_net-L1': film_net_l1,
    'film_net-VGG': film_net_vgg,
    'film_net-Style': film_net_style,
}


def get_experiment(name: str, vgg_model_file: Optional[str] = None,
                   **overrides) -> ExperimentConfig:
  if name not in _PRESETS:
    raise ValueError(f'Unknown experiment {name}; have {sorted(_PRESETS)}')
  if name == 'film_net-L1':
    return _PRESETS[name](**overrides)
  if vgg_model_file is None:
    raise ValueError(f'{name} needs --vgg_model_file (MatConvNet .mat)')
  return _PRESETS[name](vgg_model_file, **overrides)


# eval/config/*.gin parity: benchmark evaluation configurations.
@dataclasses.dataclass(frozen=True)
class EvaluationConfig:
  name: str
  tfrecord: str
  metrics: Tuple[str, ...] = ('l1', 'l2', 'ssim', 'psnr')
  max_examples: int = -1


EVAL_PRESETS: Dict[str, EvaluationConfig] = {
    'middlebury': EvaluationConfig('middlebury', 'middlebury_other.tfrecord@3'),
    'vimeo_90K': EvaluationConfig('vimeo_90K', 'vimeo_interp_test.tfrecord@3'),
    'ucf101': EvaluationConfig('ucf101', 'UCF101_interp_test.tfrecord@2'),
    'xiph_2K': EvaluationConfig('xiph_2K', 'xiph_2K.tfrecord@2'),
    'xiph_4K': EvaluationConfig('xiph_4K', 'xiph_4K.tfrecord@2'),
}
