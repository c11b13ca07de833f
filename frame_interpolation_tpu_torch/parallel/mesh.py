"""The device mesh of the sharded paths: a 1-D list of torch devices.

Counterpart of frame_interpolation_tpu/parallel/mesh.py (a 1-D
`jax.sharding.Mesh` on axis 'data'). A mesh may name one device more than
once: `[cuda:0] * 4` runs four shards on one card, and `[cpu] * 4` four
on the CPU, as the JAX tests' virtual 8-device CPU mesh does. Replicas
are made once per distinct device and shared by its shards.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

DATA_AXIS = 'data'


def _indexed(device: torch.device) -> torch.device:
  # 'cuda' and 'cuda:0' are one card: name it one way.
  if device.type == 'cuda' and device.index is None:
    return torch.device('cuda', torch.cuda.current_device())
  return device


class Mesh:
  """Devices along the one axis DATA_AXIS, one shard each."""

  def __init__(self, devices: Sequence[Any]):
    self.devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not self.devices:
      raise ValueError('a mesh needs at least one device')

  @property
  def size(self) -> int:
    return len(self.devices)

  def __repr__(self) -> str:
    return (f'Mesh({DATA_AXIS}: '
            f'{", ".join(str(d) for d in self.devices)})')


def visible_devices(device: Any = 'cuda') -> List[torch.device]:
  """Every device a mesh of `device`'s type can use: each visible GPU for
  cuda (none without a GPU), the one CPU for cpu."""
  device = torch.device(device)
  if device.type == 'cuda':
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
  return [torch.device(device.type)]


def create_mesh(devices: Optional[Sequence[Any]] = None) -> Mesh:
  """A 1-D mesh over `devices`, by default every visible GPU."""
  if devices is None:
    devices = visible_devices('cuda')
    if not devices:
      raise RuntimeError('create_mesh: no GPU is visible to torch; pass the '
                         'devices')
  return Mesh(devices)


def replicate(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
  """The model once for each shard of the mesh: a copy of its weights on
  each distinct device, shared by the shards on that device."""
  copies: Dict[torch.device, nn.Module] = {}
  for device in mesh.devices:
    if device not in copies:
      copies[device] = copy.deepcopy(model).to(device).eval()
  return [copies[d] for d in mesh.devices]


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
  """Splits axis 0 of `batch` into one equal part per shard, each moved to
  its shard's device."""
  if batch.shape[0] % mesh.size:
    raise ValueError(f'batch {batch.shape[0]} does not divide over '
                     f'{mesh.size} devices')
  return [part.to(device) for part, device in
          zip(batch.chunk(mesh.size), mesh.devices)]
