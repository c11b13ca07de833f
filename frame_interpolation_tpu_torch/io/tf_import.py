"""Importer: released TF2 FILM weights -> the port's state_dict.

The port of frame_interpolation_tpu/io/tf_import.py. The reference
releases its L1/VGG/Style models as TF2 SavedModels and as
`tf.train.Checkpoint` train dirs (README of google-research/
frame-interpolation; training/build_saved_model_cli.py:58-76). This module
maps those variables onto the film_net module tree, with the JAX
importer's names, rules and errors; the files are read by io/tf_bundle,
so neither TensorFlow nor protobuf is needed.

Name mapping (reference -> module tree, as the flax tree names it):
  * feat_net/sub_extractor/cfeat_conv_k   (feature_extractor.py:114-123)
        -> feat_net.sub_extractor.cfeat_conv_k
  * predict_flow/flow_predictor_{i}/conv_{j} and
    predict_flow/flow_predictor_shared/conv_{j}
    (pyramid_flow_estimator.py:64-83, 109-123)
        -> predict_flow.<same>
  * fusion convs are UNNAMED in the reference (fusion.py:80-101), so TF
    auto-names them (conv2d, conv2d_1, ...) with process-global counters
    that cannot be predicted. They are matched by level/slot scope where
    the reader reconstructs one (checkpoints), else by kernel shape, and
    convs that share a shape by the creation index of their Keras
    auto-name, never by the order a container lists them in.
  * Kernels are HWIO in TF, as in flax; `params_io.from_flax_params`
    turns the tree into the state_dict (OIHW).

Both containers:
  * SavedModel: `<dir>/variables/variables` is a bundle whose object graph
    pairs each variable's name ('feat_net/sub_extractor/cfeat_conv_0/
    kernel') with its key; `saved_model.pb` is never parsed.
  * Object-based checkpoint (tf.train.Checkpoint(model=...)): keys are
    attribute paths like 'model/layer_with_weights-0/extract_sublevels/
    convs/0/kernel/.ATTRIBUTES/VARIABLE_VALUE'. Layer order is feat_net,
    predict_flow, fusion (creation order in models/film_net/
    interpolator.py:129-185). Only the model's entries are read: an
    optimizer's slots and `save_counter` are skipped.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..options import Options
from . import params_io, tf_bundle

_LEVEL_SLOT_RE = re.compile(r'level_(\d+)_slot_(\d+)')
_AUTO_SUFFIX_RE = re.compile(r'(.+?)_(\d+)')


def _fusion_names_from_scopes(fusion_order: List[str]) -> Optional[Dict[str,
                                                                        str]]:
  """Maps fusion layer scopes to module names when scopes carry
  level/slot.

  The checkpoint reader (_named_vars_from_checkpoint) emits explicit
  'level_{i}_slot_{j}' / 'output_conv' scopes reconstructed from the
  object graph's attribute paths, which identify each conv unambiguously —
  no shape fingerprinting needed. Returns None when any scope lacks that
  structure (e.g. SavedModel auto-names like 'conv2d_17').
  """
  mapping: Dict[str, str] = {}
  for layer in fusion_order:
    base = layer.split('/')[-1]
    match = _LEVEL_SLOT_RE.fullmatch(base)
    if match:
      mapping[layer] = f'conv_{int(match.group(1))}_{int(match.group(2))}'
    elif base == 'output_conv':
      mapping[layer] = 'output_conv'
    else:
      return None
  return mapping


def _creation_rank(layer: str) -> Tuple[str, int]:
  """(base name, creation index) recovered from a TF auto-name.

  Keras auto-names unnamed layers with a process-global counter: the first
  instance is 'conv2d', later ones 'conv2d_1', 'conv2d_2', ... — so the
  numeric suffix orders same-base layers by creation, independently of how
  a container happens to enumerate its variables.
  """
  base = layer.split('/')[-1]
  match = _AUTO_SUFFIX_RE.fullmatch(base)
  if match:
    return match.group(1), int(match.group(2))
  return base, 0


def _aligned_channels(options: Options, level: int) -> int:
  """Channels of the aligned (fusion input) pyramid at `level`:
  2*(3 + feature_channels) + 2 + 2, two warped image+feature stacks plus
  the two flow fields."""
  return 2 * (3 + options.feature_channels(level)) + 4


def _expected_fusion_shapes(options: Options) -> List[Tuple[int, ...]]:
  """Exact kernel shapes (HWIO) of fusion convs in creation
  (fine-to-coarse) order.

  These shapes are unique per conv for any config whose filter counts vary
  by level, which lets the importer identify the reference's UNNAMED fusion
  conv layers purely by shape, independent of enumeration order.
  """
  shapes = []
  m = options.specialized_levels
  k = options.filters
  levels = options.fusion_pyramid_levels

  def num_filters(i):
    return (k << i) if i < m else (k << m)

  for i in range(levels - 1):
    nf = num_filters(i)
    # The 2x2 resize-conv consumes the decoder's running state: the aligned
    # features at the coarsest level, or the previous stage's conv output.
    cin_up = (_aligned_channels(options, i + 1)
              if i + 1 == levels - 1 else num_filters(i + 1))
    shapes.append((2, 2, cin_up, nf))
    shapes.append((3, 3, _aligned_channels(options, i) + nf, nf))
    shapes.append((3, 3, nf, nf))
  shapes.append((1, 1, num_filters(0), 3))
  return shapes


def _check_shape(got: Tuple[int, ...], want: Tuple[int, ...], what: str):
  ok = len(got) == len(want) and all(
      w is None or g == w for g, w in zip(got, want))
  if not ok:
    raise ValueError(
        f'TF weight import: {what} has shape {got}, expected {want}. '
        'The checkpoint does not match the configured Options.')


def _assign(params: Dict, path: List[str], value: np.ndarray):
  node = params
  for key in path[:-1]:
    node = node.setdefault(key, {})
  node[path[-1]] = np.asarray(value)


def _import_named_variables(named_vars: List[Tuple[str, np.ndarray]],
                            options: Options) -> Dict:
  """Builds the parameter tree (module -> kernel/bias, numpy) from
  (name, value) pairs, in any order."""
  params: Dict[str, Any] = {}
  fusion_convs: Dict[str, Dict[str, np.ndarray]] = {}
  fusion_order: List[str] = []

  known_scopes = ('feat_net', 'predict_flow', 'fusion')
  for name, value in named_vars:
    name = name.split(':')[0]
    parts = name.split('/')
    leaf = parts[-1]
    if leaf not in ('kernel', 'bias'):
      continue
    # Tolerate enclosing name scopes (e.g. a 'film_net/' or model-name
    # prefix some exports add): anchor on the first known scope component.
    anchor = next((i for i, p in enumerate(parts) if p in known_scopes),
                  None)
    if anchor is None:
      raise ValueError(f'TF weight import: unexpected variable {name}')
    parts = parts[anchor:]
    scope = parts[0]
    if scope == 'feat_net' or scope == 'predict_flow':
      _assign(params, parts, value)
    else:  # fusion
      layer = '/'.join(parts[:-1])
      if layer not in fusion_convs:
        fusion_convs[layer] = {}
        fusion_order.append(layer)
      fusion_convs[layer][leaf] = value

  expected = _expected_fusion_shapes(options)
  if len(fusion_order) != len(expected):
    raise ValueError(
        f'TF weight import: found {len(fusion_order)} fusion convs, '
        f'expected {len(expected)}.')
  levels = options.fusion_pyramid_levels
  module_names = []
  for i in range(levels - 1):
    module_names += [f'conv_{i}_0', f'conv_{i}_1', f'conv_{i}_2']
  module_names.append('output_conv')
  expected_by_name = dict(zip(module_names, expected))

  # Preferred: explicit level/slot scopes (object-checkpoint imports)
  # identify every conv by name; shapes are still validated.
  by_name = _fusion_names_from_scopes(fusion_order)
  if by_name is not None:
    if sorted(by_name.values()) != sorted(module_names):
      raise ValueError(
          'TF weight import: fusion scopes name levels/slots '
          f'{sorted(by_name.values())}, expected {sorted(module_names)}.')
    for tf_layer, module_name in by_name.items():
      _check_shape(tuple(fusion_convs[tf_layer]['kernel'].shape),
                   expected_by_name[module_name],
                   f'fusion {module_name} kernel')
      _assign(params, ['fusion', module_name, 'kernel'],
              fusion_convs[tf_layer]['kernel'])
      _assign(params, ['fusion', module_name, 'bias'],
              fusion_convs[tf_layer]['bias'])
    return params

  # Otherwise identify the (auto-named) fusion convs by kernel shape. Any
  # config where two fusion levels share filter counts (the filters<<m
  # plateau above specialized_levels) makes some 3x3 kernel shapes
  # IDENTICAL across levels; those are ordered by the creation index in
  # their TF auto-name (the process-global Keras counter), never by
  # enumeration order, and the import fails loudly when no such ordering
  # exists.
  by_shape: Dict[Tuple[int, ...], List[str]] = {}
  for tf_layer in fusion_order:
    shape = tuple(fusion_convs[tf_layer]['kernel'].shape)
    by_shape.setdefault(shape, []).append(tf_layer)
  for pool in by_shape.values():
    if len(pool) > 1:
      ranks = [_creation_rank(layer) for layer in pool]
      bases = {base for base, _ in ranks}
      indices = [index for _, index in ranks]
      if len(bases) != 1 or len(set(indices)) != len(indices):
        raise ValueError(
            'TF weight import: fusion convs '
            f'{sorted(pool)} share kernel shape '
            f'{tuple(fusion_convs[pool[0]]["kernel"].shape)} and their '
            'names carry no creation order (expected Keras auto-names '
            "like 'conv2d_7'); cannot assign them to fusion levels "
            'unambiguously.')
      pool.sort(key=lambda layer: _creation_rank(layer)[1])
  for module_name, want in zip(module_names, expected):
    pool = by_shape.get(tuple(want))
    if not pool:
      present = sorted(by_shape)
      raise ValueError(
          f'TF weight import: no fusion conv with kernel shape {want} for '
          f'{module_name}; checkpoint has {present}. The checkpoint does '
          'not match the configured Options.')
    tf_layer = pool.pop(0)
    _assign(params, ['fusion', module_name, 'kernel'],
            fusion_convs[tf_layer]['kernel'])
    _assign(params, ['fusion', module_name, 'bias'],
            fusion_convs[tf_layer]['bias'])
  return params


def _named_vars_from_saved_model(path: str) -> List[Tuple[str, np.ndarray]]:
  """(variable name, value) of every kernel and bias of a SavedModel, from
  the object graph of its variables bundle; other variables are not
  read."""
  reader = tf_bundle.BundleReader(os.path.join(path, 'variables',
                                               'variables'))
  named = []
  for full_name, key in tf_bundle.object_graph(reader):
    if not full_name:
      raise ValueError(
          f'TF weight import: the SavedModel attribute {key} has no '
          'full_name, so its variable cannot be named.')
    if full_name.split(':')[0].split('/')[-1] in ('kernel', 'bias'):
      named.append((full_name, reader.read(key)))
  return named


def _named_vars_from_checkpoint(path: str,
                                options: Options
                                ) -> List[Tuple[str, np.ndarray]]:
  """Reads an object-based checkpoint by reconstructing attribute paths."""
  if os.path.isdir(path):
    ckpt = tf_bundle.latest_checkpoint(path)
    if ckpt is None:
      raise FileNotFoundError(f'No checkpoint found under {path}')
  else:
    ckpt = path
  reader = tf_bundle.BundleReader(ckpt)
  keys = set(reader.keys())

  suffix = '/.ATTRIBUTES/VARIABLE_VALUE'

  def read(attr_path: str) -> np.ndarray:
    key = attr_path + suffix
    if key not in keys:
      raise KeyError(
          f'TF weight import: checkpoint key {key} not found; the '
          'checkpoint layout does not match the reference film_net model.')
    return reader.read(key)

  # Keras functional model tracks sublayers with weights in creation order:
  # feat_net=0, predict_flow=1, fusion=2 (interpolator.py:129-185).
  prefix = 'model'
  if not any(k.startswith('model/') for k in keys):
    # Allow checkpoints saved as tf.train.Checkpoint(net=...) etc.
    roots = {k.split('/')[0] for k in keys if suffix in k}
    roots.discard('optimizer')
    candidates = [r for r in roots
                  if f'{r}/layer_with_weights-0/extract_sublevels/convs/0/'
                  f'kernel{suffix}' in keys]
    if not candidates:
      raise ValueError(
          'TF weight import: cannot locate the model root in checkpoint; '
          f'roots present: {sorted(roots)}')
    prefix = candidates[0]

  named: List[Tuple[str, np.ndarray]] = []
  # feat_net: extract_sublevels.convs[k] == cfeat_conv_k.
  for k in range(2 * options.sub_levels):
    base = f'{prefix}/layer_with_weights-0/extract_sublevels/convs/{k}'
    named.append((f'feat_net/sub_extractor/cfeat_conv_{k}/kernel',
                  read(base + '/kernel')))
    named.append((f'feat_net/sub_extractor/cfeat_conv_{k}/bias',
                  read(base + '/bias')))
  # predict_flow: _predictors[i] for specialized, then the shared one
  # appears (repeated) at indices >= specialized_levels.
  for i in range(options.specialized_levels + 1):
    idx = min(i, options.specialized_levels)
    n_convs = options.flow_convs[idx]
    tf_name = (f'flow_predictor_{i}' if i < options.specialized_levels else
               'flow_predictor_shared')
    for j in range(n_convs + 2):
      base = f'{prefix}/layer_with_weights-1/_predictors/{idx}/_convs/{j}'
      named.append((f'predict_flow/{tf_name}/conv_{j}/kernel',
                    read(base + '/kernel')))
      named.append((f'predict_flow/{tf_name}/conv_{j}/bias',
                    read(base + '/bias')))
  # fusion: convs[i][slot] then output_conv.
  for i in range(options.fusion_pyramid_levels - 1):
    for slot in range(3):
      base = f'{prefix}/layer_with_weights-2/convs/{i}/{slot}'
      named.append((f'fusion/level_{i}_slot_{slot}/kernel',
                    read(base + '/kernel')))
      named.append((f'fusion/level_{i}_slot_{slot}/bias',
                    read(base + '/bias')))
  base = f'{prefix}/layer_with_weights-2/output_conv'
  named.append(('fusion/output_conv/kernel', read(base + '/kernel')))
  named.append(('fusion/output_conv/bias', read(base + '/bias')))
  return named


def load_tf_params(path: str,
                   options: Optional[Options] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Options]:
  """Loads released TF2 FILM weights as the port's state_dict.

  Args:
    path: SavedModel dir, checkpoint dir, or checkpoint prefix.
    options: model hyperparameters; defaults to the released config.

  Returns:
    (state_dict, options) for `FilmNet.load_state_dict` or `Interpolator`.
  """
  if options is None:
    options = Options.film_net_released()
  if params_io.is_tf_saved_model(path):
    named = _named_vars_from_saved_model(path)
  else:
    named = _named_vars_from_checkpoint(path, options)
  state = params_io.from_flax_params(_import_named_variables(named, options))
  _validate_against_template(state, options)
  return state, options


def _validate_against_template(state: Dict[str, torch.Tensor],
                               options: Options) -> None:
  """Checks the imported state_dict has a fresh model's names and
  shapes."""
  from ..models.film_net import create_model
  with torch.device('meta'):  # shapes only: no weights are allocated
    template = create_model(options).state_dict()
  t_shapes = {name: tuple(v.shape) for name, v in template.items()}
  i_shapes = {name: tuple(v.shape) for name, v in state.items()}
  missing = sorted(set(t_shapes) - set(i_shapes))
  extra = sorted(set(i_shapes) - set(t_shapes))
  if missing or extra:
    raise ValueError(
        f'TF weight import mismatch. Missing: {missing[:8]}; '
        f'unexpected: {extra[:8]}')
  for name in t_shapes:
    if t_shapes[name] != i_shapes[name]:
      raise ValueError(
          f'TF weight import: shape mismatch at {name}: '
          f'imported {i_shapes[name]} vs model {t_shapes[name]}')
