"""The weights bridge between the flax parameter tree and the port.

The JAX package keeps its parameters as a nested dict (flax tree) whose
conv leaves are `kernel` (HWIO) and `bias`. The port's FilmNet holds the
same parameters under the same module names as `weight` (OIHW) and `bias`.
`from_flax_params` turns a tree (nested dicts of numpy arrays, or anything
numpy can read) into a state_dict for `FilmNet.load_state_dict`;
`to_flax_params` is its inverse. Neither imports JAX.

`save_state_bundle` / `load_state_bundle` write and read the port's own
bundle, which the trainer exports: a directory with `options.json` (the
Options fields, as the JAX package's bundle has them) and `state_dict.pt`
(`torch.save` of the FilmNet state_dict, f32 tensors on the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..options import Options

_OPTIONS_FILE = 'options.json'
_STATE_FILE = 'state_dict.pt'


def _leaves(tree: Mapping[str, Any], prefix=()):
  for key, value in tree.items():
    if isinstance(value, Mapping):
      yield from _leaves(value, prefix + (key,))
    else:
      yield prefix + (key,), value


def from_flax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Flax tree -> the port's state_dict (HWIO kernels become OIHW)."""
  state = {}
  for path, value in _leaves(tree):
    array = np.asarray(value, dtype=np.float32)
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


def save_state_bundle(path: str, state_dict: Mapping[str, torch.Tensor],
                      options: Options) -> None:
  """Writes `options.json` and `state_dict.pt` into the directory `path`."""
  os.makedirs(path, exist_ok=True)
  with open(os.path.join(path, _OPTIONS_FILE), 'w') as f:
    json.dump(dataclasses.asdict(options), f, indent=2)
  cpu_state = {k: v.detach().cpu() for k, v in state_dict.items()}
  torch.save(cpu_state, os.path.join(path, _STATE_FILE))


def load_state_bundle(path: str) -> Tuple[Dict[str, torch.Tensor], Options]:
  """Reads (state_dict, Options) from a directory `save_state_bundle` made."""
  with open(os.path.join(path, _OPTIONS_FILE)) as f:
    fields = json.load(f)
  for key in ('flow_convs', 'flow_filters'):
    fields[key] = tuple(fields[key])
  state = torch.load(os.path.join(path, _STATE_FILE), map_location='cpu',
                     weights_only=True)
  return state, Options(**fields)
