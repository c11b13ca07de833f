#!/usr/bin/env python3
"""What the row-sharded 1080p pair costs on one CUDA GPU, shard by shard.

  python3 tools/profile_sharded.py [--pairs 3]

Drives parallel.SpatialShardedInterpolator.call_device of
frame_interpolation_tpu_torch (released config, bf16 policy, seeded random
weights, the (1, 1080, 1920, 3) pair from numpy seed 0, padded to
1088x1920) on meshes that repeat the card, [cuda:0] * n for n in 1, 2, 4,
each eagerly (graphs=False) and as its one captured program, beside the
single-device Interpolator, and prints for each:
  * ms per pair, the mean over `--pairs` pairs after one warm-up, from
    CUDA events around the call (the host's lag between launches counts);
  * the device's busy ms per pair and its idle share, from a
    torch.profiler trace of one pair: the union of the kernels' intervals
    over the host's wall time of the call;
  * the exchanges a shard makes per pair (Collective.exchange calls; 0
    for a replay, whose exchanges are the graph's stream order);
then the same meshes with the interpreter's thread switch interval cut
from its default to 0.1 ms (sys.setswitchinterval), which bounds how long
a shard woken at a barrier waits for the interpreter lock. Each line
names the card and its power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.parallel import inference as sharded  # noqa: E402
from frame_interpolation_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from frame_interpolation_tpu_torch.parallel import shard_map  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402
from profile_pair import busy_us  # noqa: E402

SHORT_SWITCH_S = 1e-4


def busy_and_wall_ms(fn):
  """The device's busy ms (the union of the kernels' intervals) and the
  host's wall ms of one fn() call under torch.profiler."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start)
  with tempfile.TemporaryDirectory() as work:
    path = Path(work) / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
  kernels = [(e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('cat') == 'kernel' and 'dur' in e]
  return busy_us(kernels) / 1e3, wall_ms


def count_exchanges(fn) -> int:
  """Collective.exchange calls of shard 0 during one fn() call."""
  calls = []
  lock = threading.Lock()
  exchange = shard_map.Collective.exchange

  def counted(self, index, value):
    if index == 0:
      with lock:
        calls.append(1)
    return exchange(self, index, value)

  shard_map.Collective.exchange = counted
  try:
    fn()
  finally:
    shard_map.Collective.exchange = exchange
  return len(calls)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--pairs', type=int, default=3)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print('profile_sharded: needs a CUDA GPU', file=sys.stderr)
    return 1
  card = measure.card_line()
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dt = torch.full((1,), 0.5, device='cuda')
  single = Interpolator(model, options, align=64, device='cuda')
  runs = [('one device', single, None)]
  for n in (1, 2, 4):
    mesh = mesh_lib.Mesh(['cuda:0'] * n)
    for graphs in (False, True):
      runs.append((f'{mesh!r} {"one graph" if graphs else "eager"}',
                   sharded.SpatialShardedInterpolator(
                       model, options, mesh, align=64, graphs=graphs), n))
  default_switch = sys.getswitchinterval()
  for switch in (default_switch, SHORT_SWITCH_S):
    sys.setswitchinterval(switch)
    try:
      for name, interp, n in runs:
        def call():
          return interp.call_device(x0, x1, dt)
        ms = measure.time_ms(call, iters=args.pairs, queued=False)
        busy, wall = busy_and_wall_ms(call)
        exchanges = 0 if n is None else count_exchanges(call)
        print(f'{name}, switch interval {switch * 1e3:.1f} ms: {ms:.3f} ms a '
              f'pair (CUDA events, mean of {args.pairs}); profiled pair: '
              f'device busy {busy:.3f} ms of {wall:.3f} ms wall, idle share '
              f'{1 - busy / wall:.3f}; {exchanges} exchanges a shard; on '
              f'{card}', flush=True)
    finally:
      sys.setswitchinterval(default_switch)
  return 0


if __name__ == '__main__':
  sys.exit(main())
