#!/usr/bin/env python3
"""The highest rate the pair path sustains, found once by a sweep.

  python3 film_bench/sweep.py --workload pair-1080p --seed 5 \
      --rates 12,14,16,17,18 --seconds 6

Sets the cell up once, then runs back-to-back requests (a closed loop,
the capacity) and a window at each rate, printing requests done a second,
p50, p95 and the last request's latency (a backlog grows where it climbs
through the window). Not part of a benchmark run: it informs the rate a
pair cell's traffic file fixes.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from film_bench import bench  # noqa: E402


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument('--workload', default='pair-1080p')
  parser.add_argument('--seed', type=int, default=5)
  parser.add_argument('--rates', default='12,14,16,17,18')
  parser.add_argument('--seconds', type=float, default=6.0)
  args = parser.parse_args()
  bench.use_checkout_caches()
  workload = bench.load_json('workloads', args.workload)
  config = bench.load_json('configs', workload['config'])
  ctx = bench.Context(args.workload, workload, config, args.seed,
                      args.seconds, False, torch.device('cuda', 0),
                      time.perf_counter())
  driver = bench.load_driver(workload['entry']).Driver(ctx)
  driver.setup()
  pair = driver.pool[0]
  start, n = time.perf_counter(), 0
  while time.perf_counter() - start < args.seconds:
    driver.interpolator(pair[:1], pair[1:], driver.dt)
    n += 1
  closed = n / (time.perf_counter() - start)
  print(json.dumps({'closed_loop_per_s': closed, 'card': bench.power_limit(),
                    'kind': torch.cuda.get_device_name(0)}), flush=True)
  for rate in (float(r) for r in args.rates.split(',')):
    workload['traffic']['rate_per_s'] = rate
    out = driver.window()
    ms = np.asarray(out['latencies_ms'])
    print(json.dumps({'rate': rate, 'done_per_s': len(ms) / args.seconds,
                      'p50': float(np.median(ms)),
                      'p95': float(np.percentile(ms, 95)),
                      'last': float(ms[-1])}), flush=True)


if __name__ == '__main__':
  main()
