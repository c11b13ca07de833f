"""Compatibility loader for the reference's gin config files (PyTorch port).

A copy of frame_interpolation_tpu/training/configs/gin_compat.py that
imports nothing of JAX: its configs, schedules and Options are the port's.
Users of google-research/frame-interpolation configure experiments with
gin (training/config/*.gin, eval/config/*.gin). This module parses the
subset of gin those files use — `key = value` bindings with Python-literal
values, comments, line continuations inside brackets, and the
`@PiecewiseConstantDecay` schedule references used by film_net-VGG/Style —
and maps them onto this framework's dataclass configs, so existing gin
files keep working:

  config = load_training_gin('film_net-Style.gin', vgg_model_file=...)
  eval_config = load_eval_gin('middlebury.gin')

Unknown bindings raise (fail-loud beats silently ignoring a hyperparameter
that mattered).
"""
from __future__ import annotations

import ast
import re
from typing import Any, Dict, Optional

from ...losses import PiecewiseConstantSchedule, constant_schedule
from ...options import Options
from . import DatasetConfig, EvaluationConfig, ExperimentConfig, LossSpec


def _strip_comments(text: str) -> str:
  lines = []
  for line in text.splitlines():
    if '#' in line:
      line = line[:line.index('#')]
    lines.append(line)
  return '\n'.join(lines)


def _join_continuations(text: str) -> list:
  """Merges lines until brackets balance (gin allows multi-line lists)."""
  merged = []
  buffer = ''
  depth = 0
  for line in text.splitlines():
    if not line.strip() and not buffer:
      continue
    buffer += line
    depth = (buffer.count('[') - buffer.count(']') +
             buffer.count('{') - buffer.count('}') +
             buffer.count('(') - buffer.count(')'))
    if depth == 0 and buffer.strip():
      merged.append(buffer.strip())
      buffer = ''
  if buffer.strip():
    merged.append(buffer.strip())
  return merged


def _parse_value(raw: str) -> Any:
  raw = raw.strip()
  # gin schedule references: keep as a marker string.
  if raw.startswith('@'):
    return ('@ref', raw[1:])
  # A list of gin references: every element starts with an UNQUOTED '@'
  # (a '@' inside a quoted string — e.g. 'train.tfrecord@200' shard specs —
  # is data, not a reference).
  if raw.startswith('['):
    inner = raw.strip('[]')
    parts = [p.strip() for p in inner.split(',') if p.strip()]
    if parts and all(p.startswith('@') for p in parts):
      return [('@ref', p[1:]) for p in parts]
  return ast.literal_eval(raw)


def parse_gin_bindings(path: str) -> Dict[str, Any]:
  """Reads `scope.param = value` bindings from a gin file."""
  with open(path) as f:
    text = _strip_comments(f.read())
  bindings: Dict[str, Any] = {}
  for statement in _join_continuations(text):
    if statement.startswith(('import ', 'include ')):
      continue
    match = re.match(r'^([\w./]+)\s*=\s*(.+)$', statement, re.S)
    if not match:
      raise ValueError(f'{path}: cannot parse gin statement: {statement!r}')
    bindings[match.group(1)] = _parse_value(match.group(2))
  return bindings


_FILM_NET_KEYS = {
    'film_net.pyramid_levels': 'pyramid_levels',
    'film_net.fusion_pyramid_levels': 'fusion_pyramid_levels',
    'film_net.specialized_levels': 'specialized_levels',
    'film_net.sub_levels': 'sub_levels',
    'film_net.flow_convs': 'flow_convs',
    'film_net.flow_filters': 'flow_filters',
    'film_net.filters': 'filters',
}


def load_training_gin(path: str,
                      vgg_model_file: Optional[str] = None
                      ) -> ExperimentConfig:
  """Maps a reference training gin file onto an ExperimentConfig."""
  bindings = parse_gin_bindings(path)
  consumed = set()

  def take(key, default=None):
    consumed.add(key)
    return bindings.get(key, default)

  model_kwargs = {}
  for gin_key, field in _FILM_NET_KEYS.items():
    value = take(gin_key)
    if value is not None:
      model_kwargs[field] = tuple(value) if isinstance(value, list) else value
  model = Options.film_net_released(**model_kwargs)

  loss_names = tuple(take('training_losses.loss_names', ['l1']))
  loss_weights = take('training_losses.loss_weights')
  schedule_refs = take('training_losses.loss_weight_schedules')
  schedule_params = take('training_losses.loss_weight_parameters')
  if loss_weights is not None:
    schedules = tuple(constant_schedule(w) for w in loss_weights)
  elif schedule_params is not None:
    schedules = tuple(
        PiecewiseConstantSchedule(tuple(p['boundaries']), tuple(p['values']))
        for p in schedule_params)
    del schedule_refs  # the @PiecewiseConstantDecay refs are implied
  else:
    schedules = tuple(constant_schedule(1.0) for _ in loss_names)

  test_names = tuple(take('test_losses.loss_names', ['l1', 'psnr', 'ssim']))
  test_weights = take('test_losses.loss_weights')
  test_schedules = (tuple(constant_schedule(w) for w in test_weights)
                    if test_weights is not None else
                    tuple(constant_schedule(1.0) for _ in test_names))

  dataset = DatasetConfig(
      file=take('training_dataset.file', ''),
      batch_size=take('training_dataset.batch_size', 8),
      crop_size=take('training_dataset.crop_size', 256),
      files=tuple(take('training_dataset.files', [])),
      crop_sizes=tuple(take('training_dataset.crop_sizes', [])),
      weights=tuple(take('training_dataset.weights', [])),
      eval_files=tuple(take('eval_datasets.files', [])),
      eval_names=tuple(take('eval_datasets.names', [])),
      eval_batch_size=take('eval_datasets.batch_size', 1),
      eval_max_examples=take('eval_datasets.max_examples', -1),
  )

  # The reference points vgg/style losses at the .mat weights via gin
  # (losses/losses.py:29-49); honor those bindings unless overridden.
  vgg_file_binding = take('vgg.vgg_model_file')
  style_file_binding = take('style.vgg_model_file')
  if vgg_model_file is None:
    vgg_model_file = vgg_file_binding or style_file_binding

  config = ExperimentConfig(
      name=take('model.name', 'film_net'),
      model=model,
      learning_rate=take('training.learning_rate', 1e-4),
      learning_rate_decay_steps=take('training.learning_rate_decay_steps',
                                     750000),
      learning_rate_decay_rate=take('training.learning_rate_decay_rate',
                                    0.464158),
      learning_rate_staircase=take('training.learning_rate_staircase', True),
      num_steps=take('training.num_steps', 3000000),
      dataset=dataset,
      training_losses=LossSpec(loss_names, schedules),
      test_losses=LossSpec(test_names, test_schedules),
      augmentations=tuple(take('data_augmentation.names', [])),
      vgg_model_file=vgg_model_file,
  )
  unknown = set(bindings) - consumed
  if unknown:
    raise ValueError(f'{path}: unsupported gin bindings: {sorted(unknown)}')
  if any(n in ('vgg', 'style') for n in loss_names) and not vgg_model_file:
    raise ValueError(f'{path}: config uses vgg/style losses; pass '
                     'vgg_model_file')
  return config


def load_eval_gin(path: str) -> EvaluationConfig:
  """Maps a reference eval gin file onto an EvaluationConfig."""
  bindings = parse_gin_bindings(path)
  known = {'experiment.name', 'evaluation.tfrecord', 'evaluation.metrics',
           'evaluation.max_examples'}
  unknown = set(bindings) - known
  if unknown:
    raise ValueError(f'{path}: unsupported gin bindings: {sorted(unknown)}')
  return EvaluationConfig(
      name=bindings.get('experiment.name', 'eval'),
      tfrecord=bindings['evaluation.tfrecord'],
      metrics=tuple(bindings.get('evaluation.metrics',
                                 ['l1', 'l2', 'ssim', 'psnr'])),
      max_examples=bindings.get('evaluation.max_examples', -1),
  )
