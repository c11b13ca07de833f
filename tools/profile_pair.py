#!/usr/bin/env python3
"""Where the time goes in the port's 1080p pair forward, on one CUDA GPU.

  python3 tools/profile_pair.py [--pairs 5] [--profiled 3] [--out DIR]

Drives `Interpolator.call_device` of frame_interpolation_tpu_torch at the
released config under the bf16 policy (seeded random weights, one
(1, 1080, 1920, 3) pair from numpy seed 0, padded to 1088x1920), after two
warm-up pairs, and prints:
  * layer times, mean ms per pair over `--pairs` pairs, from CUDA events:
    the whole call, feature extraction of both frames, flow estimation in
    both directions, and the rest of interpolate_from_features (warps,
    concats, fusion);
  * device time per pair by kernel group, from a torch.profiler trace of
    `--profiled` pairs: each kernel's own duration, summed and divided by
    the pairs;
  * the device's idle share over the profiled pairs: one minus the union
    of the kernels' intervals over the host's wall time of the loop.
With `--out`, the Chrome trace and the per-kernel table go there too. Each
output line names the card and its power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import tiling  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402

# Kernel groups, first match wins; matched against the demangled name.
GROUPS = (
    ('conv3x3_kernel (ours, B2+B3)', r'conv3x3_kernel'),
    ('warp_kernel vector path (ours, B1)', r'warp_kernel<.*true>'),
    ('warp_kernel scalar path (ours, B1)', r'warp_kernel<.*false>'),
    ('torch.cat copies', r'CatArray'),
    ('cuDNN layout and channel padding', r'nhwcAddPadding|tensorTransform|'
     r'nchwToNhwc|nhwcToNchw'),
    ('cuDNN/cuBLAS conv and GEMM kernels', r'xmma|cutlass|cudnn|'
     r'implicit_convolve|gemm|nvjet'),
    ('adds (conv bias after cuDNN, flow sums)', r'Functor_add|AddFunctor'),
    ('leaky relu', r'leaky'),
    ('copies and dtype casts', r'copy|Copy'),
    ('multiplies (flow scaling)', r'MulFunctor'),
)


def card_line() -> str:
  if not torch.cuda.is_available():
    raise SystemExit('profile_pair: torch.cuda.is_available() is false; '
                     'this script needs a CUDA GPU')
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return query.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
  """Mean device time of fn() over `iters` calls (CUDA events)."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def group_of(name: str) -> str:
  for group, pattern in GROUPS:
    if re.search(pattern, name):
      return group
  return 'other'


def busy_us(intervals) -> float:
  """Length of the union of (start, end) intervals."""
  total, reach = 0.0, float('-inf')
  for start, end in sorted(intervals):
    if end <= reach:
      continue
    total += end - max(start, reach)
    reach = end
  return total


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--pairs', type=int, default=5,
                      help='Pairs per layer timing (CUDA events).')
  parser.add_argument('--profiled', type=int, default=3,
                      help='Pairs under torch.profiler.')
  parser.add_argument('--out', default=None,
                      help='Directory for the trace and the kernel table.')
  args = parser.parse_args()

  card = card_line()
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  interpolator = Interpolator(model, options, align=64, device='cuda')
  model = interpolator.model
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  x0 = torch.from_numpy(frames[0]).cuda()
  x1 = torch.from_numpy(frames[1]).cuda()
  dt = torch.full((1,), 0.5, device='cuda')
  time_in = dt.reshape(-1, 1)
  p0, _ = tiling.pad_to_align(x0, 64)
  p1, _ = tiling.pad_to_align(x1, 64)

  for _ in range(2):
    interpolator.call_device(x0, x1, dt)
  torch.cuda.synchronize()

  with torch.inference_mode():
    f0 = model.extract_features(p0)
    f1 = model.extract_features(p1)
    layers = {
        'whole forward (call_device)': event_ms(
            lambda: interpolator.call_device(x0, x1, dt), args.pairs),
        'feature extraction, both frames': event_ms(
            lambda: (model.extract_features(p0), model.extract_features(p1)),
            args.pairs),
        'flow estimation, both directions': event_ms(
            lambda: (model.predict_flow(f0[1], f1[1]),
                     model.predict_flow(f1[1], f0[1])), args.pairs),
        'interpolate_from_features': event_ms(
            lambda: model.interpolate_from_features(f0, f1, time_in),
            args.pairs),
    }
  layers['warps + fusion (interpolate_from_features minus flow)'] = (
      layers.pop('interpolate_from_features') -
      layers['flow estimation, both directions'])
  for name, ms in layers.items():
    print(f'layer {name}: {ms:.3f} ms/pair (CUDA events, mean of '
          f'{args.pairs}; {card})')

  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(args.profiled):
      interpolator.call_device(x0, x1, dt)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start) / args.profiled
  out_dir = Path(args.out) if args.out else Path(tempfile.mkdtemp())
  out_dir.mkdir(parents=True, exist_ok=True)
  trace_path = out_dir / 'trace.json'
  prof.export_chrome_trace(str(trace_path))
  with open(trace_path) as f:
    events = json.load(f)['traceEvents']
  kernels = [e for e in events
             if e.get('cat') == 'kernel' and 'dur' in e]
  if not kernels:
    raise SystemExit('profile_pair: the trace holds no device kernels')

  by_group = collections.defaultdict(lambda: [0.0, 0])
  by_name = collections.defaultdict(lambda: [0.0, 0])
  for e in kernels:
    for table, key in ((by_group, group_of(e['name'])),
                       (by_name, e['name'])):
      table[key][0] += e['dur'] / 1e3 / args.profiled
      table[key][1] += 1
  kernel_ms = sum(ms for ms, _ in by_group.values())
  busy_ms = busy_us((e['ts'], e['ts'] + e['dur'])
                    for e in kernels) / 1e3 / args.profiled
  for group, (ms, count) in sorted(by_group.items(), key=lambda g: -g[1][0]):
    print(f'kernels {group}: {ms:.3f} ms/pair, '
          f'{count / args.profiled:.1f} launches/pair')
  print(f'device: {kernel_ms:.3f} ms/pair of kernels, {busy_ms:.3f} ms/pair '
        f'busy, host wall {wall_ms:.3f} ms/pair, idle share '
        f'{1.0 - busy_ms / wall_ms:.3f} (torch.profiler over '
        f'{args.profiled} pairs; {card})')
  if args.out:
    with open(out_dir / 'kernels.txt', 'w') as f:
      for name, (ms, count) in sorted(by_name.items(),
                                      key=lambda k: -k[1][0]):
        f.write(f'{ms:9.3f} ms/pair {count / args.profiled:6.1f}/pair  '
                f'{name}\n')
  else:
    os.remove(trace_path)
    os.rmdir(out_dir)
  return 0


if __name__ == '__main__':
  sys.exit(main())
