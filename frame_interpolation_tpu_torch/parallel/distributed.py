"""Data-parallel training across processes (torch.distributed).

Port of frame_interpolation_tpu/parallel/distributed.py. There, each host
calls `initialize_multihost` and one jitted step runs over a device mesh
that spans every process; XLA all-reduces the gradients. Here each process
(a rank) holds a replica of the model on one device, trains on its slice
of the global batch (`process_batch_slice`), and the train step averages
the gradients over the ranks before Adam (training/train_lib.py), so a
step on N ranks is a step of one process on the global batch.

The backend is NCCL when the processes of a host each have a card of their
own, and gloo otherwise: on the CPU, or when ranks share a card (NCCL
refuses two ranks on one GPU; gloo all-reduces CUDA tensors through the
host). A host's process count is `LOCAL_WORLD_SIZE` (torchrun sets it),
else every process is taken to be on this host. A rank's device is
`cuda:{LOCAL_RANK or process_id} % device_count`.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
  """Whether this process is a rank of an initialized process group."""
  return dist.is_available() and dist.is_initialized()


def world_size() -> int:
  return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
  return dist.get_rank() if is_initialized() else 0


def choose_backend(device_type: str, num_processes: int) -> str:
  """'nccl' when every process of this host has a GPU of its own, else
  'gloo' (the CPU, or ranks that share a card)."""
  local = int(os.environ.get('LOCAL_WORLD_SIZE', num_processes))
  if (device_type == 'cuda' and torch.cuda.is_available() and
      local <= torch.cuda.device_count()):
    return 'nccl'
  return 'gloo'


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device_type: str = 'cuda') -> Optional[str]:
  """Joins the process group; a no-op (returning None) when both
  `coordinator_address` and `num_processes` are None, as JAX's is.

  `coordinator_address` is rank 0's 'host:port' (a TCP rendezvous), or a
  URL init_method such as 'file:///shared/rendezvous'. `device_type` is
  the device the ranks train on ('cuda' or 'cpu'), which chooses the
  backend (logged). Returns the backend. Call it before anything touches
  the device.
  """
  if coordinator_address is None and num_processes is None:
    return None
  if coordinator_address is None or num_processes is None or (
      process_id is None):
    raise ValueError('multi-process training needs coordinator_address, '
                     'num_processes and process_id; got '
                     f'{coordinator_address!r}, {num_processes!r}, '
                     f'{process_id!r}')
  if not 0 <= process_id < num_processes:
    raise ValueError(f'process_id {process_id} is not in [0, '
                     f'{num_processes})')
  backend = choose_backend(device_type, num_processes)
  init_method = (coordinator_address if '://' in coordinator_address
                 else f'tcp://{coordinator_address}')
  dist.init_process_group(backend, init_method=init_method,
                          world_size=num_processes, rank=process_id)
  logging.info('process %d of %d joined %s over %s', process_id,
               num_processes, init_method, backend)
  return backend


def shutdown() -> None:
  """Leaves the process group, if this process is in one."""
  if is_initialized():
    dist.destroy_process_group()


def rank_device(device_type: str) -> torch.device:
  """This rank's device: the CPU, or `cuda:{LOCAL_RANK or rank} %
  device_count`."""
  if device_type != 'cuda':
    return torch.device(device_type)
  local = int(os.environ.get('LOCAL_RANK', rank()))
  return torch.device('cuda', local % torch.cuda.device_count())


def process_batch_slice(global_batch: int) -> Tuple[int, int]:
  """(start, size) of this process's slice of a global batch; (0,
  global_batch) outside a process group."""
  count = world_size()
  if global_batch % count != 0:
    raise ValueError(
        f'global batch {global_batch} must divide process count {count}')
  per = global_batch // count
  return rank() * per, per


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """The mean over the ranks of each tensor, by one all-reduce of their
  concatenation (one collective a step, whatever the parameter count).
  Every rank gets the same bits."""
  if not tensors:
    return []
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  dist.all_reduce(flat, op=dist.ReduceOp.SUM)
  flat /= world_size()
  out, offset = [], 0
  for t in tensors:
    out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
    offset += t.numel()
  return out


def barrier() -> None:
  """Waits for every rank; a no-op outside a process group."""
  if is_initialized():
    dist.barrier()
