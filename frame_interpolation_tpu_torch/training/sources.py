"""Training-source resolution shared by the train CLI and tests.

Port of frame_interpolation_tpu/training/sources.py (plain Python).

Maps flags/config onto (TrainingSource list, sampling weights), with the
reference's files/file deprecation precedence (training/data_lib.py:242-259
in google-research/frame-interpolation).
"""
from __future__ import annotations


def build_training_sources(dataset_lib, config_dataset, train_file,
                           train_files, crop_sizes, default_crop_size,
                           train_weights):
  """Resolves (sources, weights) from flags and the experiment config.

  Precedence: --train_files > --train_file > config files > config file —
  mirroring the reference's files/file deprecation order
  (training/data_lib.py:242-259).
  """
  weights = [float(w) for w in train_weights] or None
  if train_files:
    sizes = [int(s) for s in crop_sizes] or [default_crop_size] * len(
        train_files)
    if len(sizes) != len(train_files):
      raise ValueError('--crop_sizes must match --train_files '
                       f'({len(sizes)} vs {len(train_files)})')
    files = list(train_files)
  elif train_file:
    files, sizes = [train_file], [default_crop_size]
  elif config_dataset.files:
    files = list(config_dataset.files)
    sizes = list(config_dataset.crop_sizes) or [default_crop_size] * len(
        files)
    weights = weights or (list(config_dataset.weights) or None)
  elif config_dataset.file:
    files, sizes = [config_dataset.file], [default_crop_size]
  else:
    raise ValueError('no training source: pass --train_files/--train_file '
                     'or configure training_dataset.files')
  if weights is not None and len(weights) != len(files):
    raise ValueError('--train_weights must match the training sources '
                     f'({len(weights)} vs {len(files)})')
  sources = [dataset_lib.TrainingSource(f, s) for f, s in zip(files, sizes)]
  return sources, weights
