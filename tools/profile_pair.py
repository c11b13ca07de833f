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
Then it profiles three film_net-L1 train steps the same way (released
config, f32, batch 8 of 256x256 random triplets, the lean step of
train_lib without augmentation, PyTorch's default TF32 for convs, after
two warm-up steps): device time by kernel group per step and the idle
share. With `--out`, the Chrome traces and the per-kernel tables go
there too. Each output line names the card and its power limit. Needs a
GPU. The whole pair and the step take the port's default on the card, a
captured CUDA graph (utils/programs.py); the pair's parts run the model's
methods eagerly.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch import losses  # noqa: E402
from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import tiling  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.training import configs, train_lib  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402

TRAIN_STEPS = 3  # train steps under torch.profiler

# Kernel groups, first match wins; matched against the demangled name. The
# warp has two routes, warp_vector_kernel<T, planes> (C a multiple of the
# 16-byte vector) and warp_run_kernel<T, planes> (any other C); the planes
# mode of either is B4. The splat is five kernels, splat_index_kernel,
# splat_scan_kernel, splat_tile_sum_kernel<T>, splat_long_sum_kernel<T>.
GROUPS = (
    ('conv3x3_wgmma_kernel (ours, B2+B3)', r'conv3x3_wgmma_kernel'),
    ('conv3x3_fma_kernel (ours, B2+B3, exact f32)', r'conv3x3_fma_kernel'),
    ('warp planes mode, both routes (ours, B4)',
     r'warp_(vector|run)_kernel<[^,<>]+, true>'),
    ('warp_vector_kernel (ours, B1)', r'warp_vector_kernel<[^,<>]+, false>'),
    ('warp_run_kernel, odd C (ours, B1)', r'warp_run_kernel<[^,<>]+, false>'),
    ('splat kernels (ours, B5+B6)', r'splat_'),
    ('torch.cat copies', r'CatArray'),
    ('cuDNN layout and channel padding', r'nhwcAddPadding|tensorTransform|'
     r'nchwToNhwc|nhwcToNchw'),
    ('cuDNN/cuBLAS conv and GEMM kernels', r'xmma|cutlass|cudnn|'
     r'implicit_convolve|gemm|nvjet'),
    ('reductions (bias gradients, flow cotangent, loss)', r'reduce_kernel'),
    ('adds (conv bias after cuDNN, flow sums)', r'Functor_add|AddFunctor'),
    ('leaky relu and its where', r'leaky|where'),
    ('copies and dtype casts', r'copy|Copy'),
    ('multiplies (flow scaling)', r'MulFunctor'),
)


def card_line() -> str:
  if not torch.cuda.is_available():
    raise SystemExit('profile_pair: torch.cuda.is_available() is false; '
                     'this script needs a CUDA GPU')
  return measure.card_line()


def group_of(name: str) -> str:
  for group, pattern in GROUPS:
    if re.search(pattern, name):
      return group
  return 'other'


def profile(fn, count: int, unit: str, card: str, out_dir: Path,
            label: str) -> None:
  """Runs fn() `count` times under torch.profiler and prints device time
  by kernel group per call, and the device's idle share."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(count):
      fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start) / count
  trace_path = out_dir / f'trace_{label}.json'
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
      table[key][0] += e['dur'] / 1e3 / count
      table[key][1] += 1
  kernel_ms = sum(ms for ms, _ in by_group.values())
  busy_ms = measure.busy_us((e['ts'], e['ts'] + e['dur'])
                            for e in kernels) / 1e3 / count
  for group, (ms, n) in sorted(by_group.items(), key=lambda g: -g[1][0]):
    print(f'kernels ({label}) {group}: {ms:.3f} ms/{unit}, '
          f'{n / count:.1f} launches/{unit}')
  print(f'device ({label}): {kernel_ms:.3f} ms/{unit} of kernels, '
        f'{busy_ms:.3f} ms/{unit} busy, host wall {wall_ms:.3f} ms/{unit}, '
        f'idle share {1.0 - busy_ms / wall_ms:.3f} (torch.profiler over '
        f'{count} {unit}s; {card})')
  with open(out_dir / f'kernels_{label}.txt', 'w') as f:
    for name, (ms, n) in sorted(by_name.items(), key=lambda k: -k[1][0]):
      f.write(f'{ms:9.3f} ms/{unit} {n / count:6.1f}/{unit}  {name}\n')


def train_step_fn():
  """The film_net-L1 lean train step on random batch-8 256x256 triplets."""
  config = configs.get_experiment('film_net-L1')
  model = init_params(create_model(config.model),
                      torch.Generator().manual_seed(0)).cuda()
  opts = train_lib.TrainingOptions()
  step_fn = train_lib.make_train_step(losses.training_losses(['l1']), opts,
                                      with_summaries=False)
  state = train_lib.create_train_state(model, opts)
  rng = np.random.RandomState(1)
  batch = train_lib.batch_to_device(
      {k: rng.rand(8, 256, 256, 3).astype(np.float32)
       for k in ('x0', 'x1', 'y')} | {'time': np.full((8, 1), 0.5)},
      torch.device('cuda'))
  return lambda: step_fn(state, batch, torch.Generator())


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--pairs', type=int, default=5,
                      help='Pairs per layer timing (CUDA events).')
  parser.add_argument('--profiled', type=int, default=3,
                      help='Pairs under torch.profiler.')
  parser.add_argument('--out', default=None,
                      help='Directory for the traces and the kernel tables.')
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
        'whole forward (call_device)': lambda: interpolator.call_device(
            x0, x1, dt),
        'feature extraction, both frames': lambda: (
            model.extract_features(p0), model.extract_features(p1)),
        'flow estimation, both directions': lambda: (
            model.predict_flow(f0[1], f1[1]),
            model.predict_flow(f1[1], f0[1])),
        'interpolate_from_features': lambda: model.interpolate_from_features(
            f0, f1, time_in),
    }
    # The host's lag between launches counts, as in chip_smoke.py's
    # serving time.
    layers = {name: measure.time_ms(fn, args.pairs, queued=False)
              for name, fn in layers.items()}
  layers['warps + fusion (interpolate_from_features minus flow)'] = (
      layers.pop('interpolate_from_features') -
      layers['flow estimation, both directions'])
  for name, ms in layers.items():
    print(f'layer {name}: {ms:.3f} ms/pair (CUDA events, mean of '
          f'{args.pairs}; {card})')

  out_dir = Path(args.out) if args.out else Path(tempfile.mkdtemp())
  out_dir.mkdir(parents=True, exist_ok=True)
  profile(lambda: interpolator.call_device(x0, x1, dt), args.profiled,
          'pair', card, out_dir, 'pair')
  del interpolator, model, f0, f1
  step = train_step_fn()
  for _ in range(2):
    step()
  profile(step, TRAIN_STEPS, 'step', card, out_dir, 'train')
  if not args.out:
    shutil.rmtree(out_dir)
  return 0


if __name__ == '__main__':
  sys.exit(main())
