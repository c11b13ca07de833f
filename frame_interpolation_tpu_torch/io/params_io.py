"""The weights bridge between the flax parameter tree and the port.

The JAX package keeps its parameters as a nested dict (flax tree) whose
conv leaves are `kernel` (HWIO) and `bias`. The port's FilmNet holds the
same parameters under the same module names as `weight` (OIHW) and `bias`.
`from_flax_params` turns a tree (nested dicts of numpy arrays, or anything
numpy can read) into a state_dict for `FilmNet.load_state_dict`;
`to_flax_params` is its inverse. Neither imports JAX.

Two bundles, each a directory with `options.json` (the Options fields):

  * the port's own, which the trainer exports: `state_dict.pt`, the
    `torch.save` of the FilmNet state_dict, f32 tensors on the CPU
    (`save_state_bundle` / `load_state_bundle`);
  * the JAX package's: `params.msgpack`, the flax tree as
    `flax.serialization.to_bytes` writes it (`save_params` / `load_params`,
    through io/msgpack_lite, so neither needs flax or msgpack). JAX's
    `io.params_io.load_params` reads what `save_params` writes.

A TF release (a SavedModel or a checkpoint of the reference, told apart
by `is_tf_saved_model` / `is_tf_checkpoint_dir`) is read by
io/tf_import.load_tf_params.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..options import Options
from . import msgpack_lite

OPTIONS_FILE = 'options.json'
STATE_FILE = 'state_dict.pt'
PARAMS_FILE = 'params.msgpack'
# Fields of the JAX package's Options that the port does not have: they
# choose between TPU execution layouts, and a bundle's values are dropped.
# (split_convs is a field of both and loads.)
_JAX_ONLY_FIELDS = ('warp_impl', 'fold_convs', 'conv_stack')


def _leaves(tree: Mapping[str, Any], prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def _as_f32_numpy(value: Any) -> np.ndarray:
  if isinstance(value, torch.Tensor):  # bfloat16 leaves of a JAX bundle
    return value.detach().float().cpu().numpy()
  return np.asarray(value, dtype=np.float32)


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Flax tree -> the port's state_dict (HWIO kernels become OIHW)."""
  state = {}
  for path, value in _leaves(tree):
    array = _as_f32_numpy(value)
    module = '.'.join(path[:-1])
    if path[-1] == 'kernel':
      state[f'{module}.weight'] = torch.from_numpy(
          np.ascontiguousarray(array.transpose(3, 2, 0, 1)))
    elif path[-1] == 'bias':
      state[f'{module}.bias'] = torch.from_numpy(np.array(array))
    else:
      raise ValueError(f'unexpected flax leaf {"/".join(path)}')
  return state


def to_flax_params(
    state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """The port's state_dict -> flax tree of numpy arrays (OIHW -> HWIO)."""
  tree: Dict[str, Any] = {}
  for name, tensor in state_dict.items():
    *modules, leaf = name.split('.')
    array = tensor.detach().float().cpu().numpy()
    node = tree
    for module in modules:
      node = node.setdefault(module, {})
    if leaf == 'weight':
      node['kernel'] = np.ascontiguousarray(array.transpose(2, 3, 1, 0))
    elif leaf == 'bias':
      node['bias'] = array
    else:
      raise ValueError(f'unexpected state_dict entry {name}')
  return tree


def write_options(path: str, options: Options) -> None:
  """Writes `options` as `<path>/options.json`."""
  os.makedirs(path, exist_ok=True)
  with open(os.path.join(path, OPTIONS_FILE), 'w') as f:
    json.dump(dataclasses.asdict(options), f, indent=2)


def read_options(path: str) -> Options:
  """Options from a bundle's options.json; the JAX package's layout
  fields are dropped, any other field the port does not know raises."""
  with open(os.path.join(path, OPTIONS_FILE)) as f:
    fields = json.load(f)
  for key in _JAX_ONLY_FIELDS:
    fields.pop(key, None)
  known = {f.name for f in dataclasses.fields(Options)}
  unknown = sorted(set(fields) - known)
  if unknown:
    raise ValueError(f'{path}/{OPTIONS_FILE}: unknown Options fields '
                     f'{unknown}')
  for key in ('flow_convs', 'flow_filters'):
    if key in fields:
      fields[key] = tuple(fields[key])
  return Options(**fields)


def save_state_bundle(path: str, state_dict: Mapping[str, torch.Tensor],
                      options: Options) -> None:
  """Writes `options.json` and `state_dict.pt` into the directory `path`."""
  write_options(path, options)
  cpu_state = {k: v.detach().cpu() for k, v in state_dict.items()}
  torch.save(cpu_state, os.path.join(path, STATE_FILE))


def load_state_bundle(path: str) -> Tuple[Dict[str, torch.Tensor], Options]:
  """Reads (state_dict, Options) from a directory `save_state_bundle` made."""
  options = read_options(path)
  state = torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                     weights_only=True)
  return state, options


def is_jax_bundle(path: str) -> bool:
  """Whether `path` holds the JAX package's bundle (options.json +
  params.msgpack)."""
  return (os.path.isfile(os.path.join(path, OPTIONS_FILE)) and
          os.path.isfile(os.path.join(path, PARAMS_FILE)))


def is_tf_saved_model(path: str) -> bool:
  """Whether `path` is a TF2 SavedModel directory (io/tf_import reads its
  variables)."""
  return (os.path.isfile(os.path.join(path, 'saved_model.pb')) or
          os.path.isfile(os.path.join(path, 'saved_model.pbtxt')))


def is_tf_checkpoint_dir(path: str) -> bool:
  """Whether `path` is a TF checkpoint directory or prefix."""
  if os.path.isfile(os.path.join(path, 'checkpoint')):
    return True
  if os.path.isdir(path):
    return any(name.endswith('.index') for name in os.listdir(path))
  # A checkpoint prefix like /dir/ckpt-183 (no extension).
  return os.path.isfile(path + '.index')


def save_params(path: str, state_dict: Mapping[str, torch.Tensor],
                options: Options) -> None:
  """Writes the JAX package's bundle: `options.json` and the flax tree of
  `state_dict` as `params.msgpack` (JAX io/params_io.save_params)."""
  write_options(path, options)
  payload = msgpack_lite.serialize(to_flax_params(state_dict))
  with open(os.path.join(path, PARAMS_FILE), 'wb') as f:
    f.write(payload)


def load_params(path: str) -> Tuple[Dict[str, torch.Tensor], Options]:
  """Reads (state_dict, Options) from the JAX package's bundle; the tree
  is `variables['params']` of the JAX FilmNet, module -> kernel/bias."""
  options = read_options(path)
  with open(os.path.join(path, PARAMS_FILE), 'rb') as f:
    tree = msgpack_lite.restore(f.read())
  if not isinstance(tree, dict):
    raise ValueError(f'{path}/{PARAMS_FILE}: not a parameter tree')
  return from_flax_params(tree), options
