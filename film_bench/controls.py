#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

  python3 film_bench/controls.py --workload pair-1080p --seeds 1-12 \
      --control-seeds 1-3 --seconds 3

For each seed: the cell's set-up, a short window at the cell's own load,
the program's readings against the reference (what a run compares), and
for the control seeds also the control's: where the configuration names
a `program_control` (the program's own path in the precision below its
own, as configuration overrides), that program's readings; else the
reference one precision below the configuration's (reference/lowp.py) in
the program's place. For a training cell also the fault of half the
batch left out, planted in the reference, in every checked step and in
the replays alone. One JSON line a seed and kind.
A benchmark run does not run this.
"""
import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from film_bench import bench  # noqa: E402
from film_bench.reference import lowp  # noqa: E402


def seeds(text: str):
  lo, _, hi = text.partition('-')
  return range(int(lo), int(hi or lo) + 1)


def readings(workload, config, seed, seconds, **check):
  """One set-up, window and check; every number the check reads."""
  ctx = bench.Context(workload['name'], workload, config, seed, seconds,
                      False, torch.device('cuda', 0), time.perf_counter())
  driver = bench.load_driver(workload['entry']).Driver(ctx)
  driver.setup()
  outcome = driver.window()
  driver.release()
  torch.cuda.empty_cache()
  start = time.perf_counter()
  out = {k: v for k, v, _ in driver.check(**check)}
  out.update(getattr(driver, 'readings', {}))
  return driver, outcome, out, time.perf_counter() - start


def overridden(config: dict, overrides: dict) -> dict:
  out = copy.deepcopy(config)
  for key, value in overrides.items():
    if isinstance(value, dict):
      out[key] = overridden(out.get(key, {}), value)
    else:
      out[key] = value
  return out


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', default='1-12')
  parser.add_argument('--control-seeds', default='1-3')
  parser.add_argument('--seconds', type=float, default=3.0)
  parser.add_argument('--base', type=int, default=2**31 + 977)
  parser.add_argument('--controls-only', action='store_true')
  args = parser.parse_args()
  bench.use_checkout_caches()
  workload = bench.load_json('workloads', args.workload)
  config = bench.load_json('configs', workload['config'])
  below = lowp.BELOW.get(config['precision'])
  controls = set(seeds(args.control_seeds))
  print(json.dumps({'card': bench.power_limit(),
                    'kind': torch.cuda.get_device_name(0),
                    'control': below}), flush=True)
  program_control = config.get('program_control')
  for s in seeds(args.seeds):
    seed = args.base + s
    if s in controls and program_control:
      _, _, control, _ = readings(workload, overridden(config, program_control),
                                  seed, args.seconds)
      print(json.dumps({'seed': seed, 'kind': 'control', 'control':
                        program_control, 'readings': control}), flush=True)
      torch.cuda.empty_cache()
    if args.controls_only:
      continue
    driver, outcome, program, check_s = readings(workload, config, seed,
                                                 args.seconds)
    print(json.dumps({'seed': seed, 'kind': 'program', 'readings': program,
                      'metrics': outcome['metrics'], 'check_s': check_s}),
          flush=True)
    if s in controls and below:
      control = {k: v for k, v, _ in driver.check(quant=below)}
      control.update(getattr(driver, 'readings', {}))
      print(json.dumps({'seed': seed, 'kind': 'control', 'readings': control}),
            flush=True)
    if s in controls and workload['entry'] == 'train_step':
      for kind in ('half_batch', 'half_batch_replays'):
        fault = {k: v for k, v, _ in driver.check(fault=kind)}
        fault.update(driver.readings)
        print(json.dumps({'seed': seed, 'kind': kind, 'readings': fault}),
              flush=True)
    del driver
    torch.cuda.empty_cache()


if __name__ == '__main__':
  main()
