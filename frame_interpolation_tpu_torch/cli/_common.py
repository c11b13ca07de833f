"""Helpers shared by the port's CLIs (JAX cli/_common.py's counterparts)."""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Mapping, Optional, Sequence

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


def to_mesh_interpolator(interpolator, mode: Optional[str],
                         align: Optional[int],
                         block_shape: Optional[Sequence[int]] = None,
                         kind: str = 'pair'):
  """`--mesh`: wraps a loaded Interpolator in a sharded class (parallel/)
  over every visible device of its type.

  mode: 'none' or None (the interpolator as it is), 'data' (a pair's
  patches, kind='pair', or the frame tree's nodes, kind='video', split over
  the mesh) or 'spatial' (the rows of one full-frame forward, kind='pair'
  only). With one visible device it logs so and serves unsharded, as the
  JAX package's CLIs do.
  """
  if not mode or mode == 'none':
    return interpolator
  from ..parallel import inference as sharded
  from ..parallel import mesh as mesh_lib
  if kind == 'video' and mode != 'data':
    raise ValueError('directory interpolation shards the frame tree; only '
                     f'--mesh data applies (got {mode!r})')
  if mode not in ('data', 'spatial'):
    raise ValueError(f'unknown --mesh mode: {mode!r}')
  devices = mesh_lib.visible_devices(interpolator.device)
  if len(devices) == 1:
    logging.info('--mesh %s requested but only one device is visible; '
                 'running single-device.', mode)
    return interpolator
  mesh = mesh_lib.create_mesh(devices)
  logging.info('--mesh %s over %s', mode, mesh)
  model, options = interpolator.model, interpolator.options
  if kind == 'video':
    return sharded.ShardedVideoInterpolator(model, options, mesh, align=align)
  if mode == 'spatial':
    return sharded.SpatialShardedInterpolator(model, options, mesh,
                                              align=align)
  block_shape = tuple(block_shape or (1, 1))
  if block_shape[0] * block_shape[1] < mesh.size:
    logging.warning('--mesh data splits the %s patch grid over %d devices; '
                    'pass --block_height/--block_width so that the patches '
                    'cover the mesh (the others run copies).', block_shape,
                    mesh.size)
  return sharded.ShardedInterpolator(model, options, mesh, block_shape,
                                     align=align)


def triplet_record_parser(description: str, num_shards: int
                          ) -> argparse.ArgumentParser:
  """The flags every dataset builder shares (JAX cli/create_*_tfrecord's
  names and defaults)."""
  parser = argparse.ArgumentParser(description=description)
  parser.add_argument('--output_tfrecord_filepath', required=True,
                      help='Output TFRecord filepath; shards are written '
                      'as <path>-0000i-of-0000N.')
  parser.add_argument('--num_shards', type=int, default=num_shards,
                      help='Output shards.')
  parser.add_argument('--num_workers', type=int, default=8,
                      help='Builder threads.')
  return parser


def write_triplet_records(args: argparse.Namespace,
                          triplet_dicts: Sequence[Mapping[str, str]],
                          scale_factor: int = 1,
                          center_crop_factor: int = 1) -> int:
  """Runs the triplet pipeline (data/builders/triplets.py) into the
  builder's shards; returns the number of examples written."""
  from ..data.builders import triplets
  written = triplets.run_pipeline(
      triplet_dicts, args.output_tfrecord_filepath, args.num_shards,
      scale_factor=scale_factor, center_crop_factor=center_crop_factor,
      num_workers=args.num_workers)
  logging.info("Succeeded in creating the output TFRecord file: '%s@%s' "
               '(%d examples).', args.output_tfrecord_filepath,
               args.num_shards, written)
  return written
