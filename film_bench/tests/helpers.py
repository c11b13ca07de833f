"""Runs a cell's driver on the CPU at a tiny size: the harness without
its look for a card, for the tests."""
from __future__ import annotations

import copy
import time

import torch

from film_bench import bench

TINY_MODEL = {'pyramid_levels': 4, 'fusion_pyramid_levels': 3,
              'specialized_levels': 2, 'flow_convs': [1, 1, 1],
              'flow_filters': [8, 8, 8], 'sub_levels': 3, 'filters': 4}
TINY_TRAFFIC = {
    'pair-1080p': {'height': 40, 'width': 56, 'pool': 3, 'check_pairs': 2,
                   'rate_per_s': 50.0},
    'train-style-256': {'crop': 32, 'batch': 2, 'pool': 4},
    'video-1080p-t3': {'height': 24, 'width': 40, 'frames': 4, 'times': 2,
                       'warmup_frames': 3, 'check_frames': 3},
}
TINY_VGG = (4, 4, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8)


def tiny(cell: str):
  """The cell's workload and configuration, cut to a CPU test's size."""
  workload = copy.deepcopy(bench.load_json('workloads', cell))
  config = copy.deepcopy(bench.load_json('configs', workload['config']))
  config['model'].update(TINY_MODEL)
  config['align'] = 8
  workload['traffic'].update(TINY_TRAFFIC[cell])
  return workload, config


def context(cell: str, seed: int = 3, seconds: float = 0.5,
            trace: bool = False) -> bench.Context:
  workload, config = tiny(cell)
  return bench.Context(cell, workload, config, seed, seconds, trace,
                       torch.device('cpu'), time.perf_counter())


def drive(ctx: bench.Context, driver_cls=None):
  """set-up, window, release, check: (window's outcome, checks)."""
  driver = (driver_cls or bench.load_driver(ctx.workload['entry']).Driver)(ctx)
  driver.setup()
  outcome = driver.window()
  driver.release()
  return outcome, driver.check()
