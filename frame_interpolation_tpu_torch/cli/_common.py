"""Helpers shared by the port's CLIs (JAX cli/_common.py's counterparts)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


def device_from_flag(name: str) -> torch.device:
  """The `--device` flag as a torch device; cuda raises without a GPU (no
  fallback to the CPU)."""
  device = torch.device(name)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('--device cuda requested but no GPU is visible to '
                       'torch.')
  return device


def load_interpolator_from_flag(params: str, align: Optional[int],
                                block_shape: Optional[Sequence[int]],
                                device, dtype_policy: Optional[str] = None):
  """An Interpolator from `--params`: 'random' (the released config,
  weights from seed 0) or a bundle, the port's or the JAX package's
  (inference.load_interpolator). `dtype_policy`, when given, overrides the
  config's or the bundle's own."""
  from ..inference import Interpolator, load_interpolator
  if params != 'random':
    return load_interpolator(params, align=align, block_shape=block_shape,
                             dtype_policy=dtype_policy, device=device)
  from ..models.film_net import create_model, init_params
  from ..options import Options
  options = Options.film_net_released()
  if dtype_policy:
    options = dataclasses.replace(options, dtype_policy=dtype_policy)
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  return Interpolator(model, options, align=align, block_shape=block_shape,
                      device=device)
