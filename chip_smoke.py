#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

  python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from frame_interpolation_tpu_torch/csrc with
nvcc, holds each kernel against its plain PyTorch version at the shapes of
the 1080p main path, then serves three 1080p pair requests through the
port's Interpolator (released config, bf16 policy, seeded random weights)
and checks the result: shape, finiteness, repeatability, the kernel launch
counts of the main path, and agreement with the same forward run through
the plain versions. Each phase prints one line; the second-to-last line is
the per-kernel JSON record and the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero before that
line. Needs a GPU: without one it exits non-zero and prints no result.
It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.models import create_model, init_params
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack, warp
from frame_interpolation_tpu_torch.options import Options

WARP_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
WARP_F32_BOUND = 1e-5          # max-abs
CONV_BF16_BOUND = 1e-2         # max|k - p| / max|p|
CONV_F32_BOUND = 1e-4          # same, TF32 off on the plain side
PSNR_BOUND_DB = 30.0           # kernels vs plain versions, whole forward
REPEAT_BOUND = 1e-6            # max-abs between repeated requests
REQUESTS = 3
# Launches per 1080p pair (released config): 12 flow-estimator warps + 10
# fusion warps; per frame 7 C=64 second convs and 15 wider second convs +
# 9 rectangular first convs, and each frame is extracted separately.
PAIR_LAUNCHES = {'warp': 22, 'conv3x3_c64': 14, 'conv3x3_wide': 48}
REPLACES = {
    'warp': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'conv3x3_c64': 'frame_interpolation_tpu/ops/conv_stack.py:141',
    'conv3x3_wide': 'frame_interpolation_tpu/ops/conv_stack_wide.py:124',
}
SOURCES = {
    'warp': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'conv3x3_c64': 'frame_interpolation_tpu_torch/csrc/conv3x3.cu',
    'conv3x3_wide': 'frame_interpolation_tpu_torch/csrc/conv3x3.cu',
}


class CheckFailed(Exception):
  pass


def device_line() -> str:
  if not torch.cuda.is_available():
    raise CheckFailed('torch.cuda.is_available() is false: this smoke test '
                      'needs a CUDA GPU')
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return query.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
  """Mean device time of fn() over `iters` launches, after one warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def smooth_seam_flow(h: int, w: int) -> torch.Tensor:
  """Smooth +-30 px flow plus a 40 px motion seam (the warp's hard case)."""
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
  flow = np.stack([30 * np.sin(yy / 97.0) * np.cos(xx / 131.0),
                   30 * np.cos(yy / 89.0) * np.sin(xx / 151.0)], axis=-1)
  flow[:, :w // 2] += 40.0
  return torch.from_numpy(flow[None].astype(np.float32)).cuda()


def check_warp(rng, h, w, c, dtype, bound, batch=1, timed=True):
  image = torch.from_numpy(rng.rand(batch, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flow = smooth_seam_flow(h, w).expand(batch, h, w, 2).contiguous()
  got = warp.backward_warp_kernel(image, flow)
  want = warp.backward_warp_plain(image, flow)
  torch.cuda.synchronize()
  err = (got.float() - want.float()).abs().max().item()
  result = {
      'shape': f'{batch}x{h}x{w}x{c}', 'dtype': str(dtype).split('.')[-1],
      'max_abs_err': err, 'bound': bound, 'ok': err <= bound,
  }
  if timed:
    result['ms'] = time_ms(lambda: warp.backward_warp_kernel(image, flow))
    result['plain_ms'] = time_ms(
        lambda: warp.backward_warp_plain(image, flow))
  return result


def check_conv(rng, h, w, cin, cout, pool, dtype, bound, batch=1,
               timed=True):
  x = torch.from_numpy(
      (rng.rand(batch, h, w, cin) * 2 - 1).astype(np.float32))
  x = x.to('cuda', dtype)
  std = (9.0 * cin)**-0.5
  weight = torch.from_numpy(
      (rng.randn(cout, cin, 3, 3) * std).astype(np.float32)).cuda()
  bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda()
  got = conv_stack.conv3x3_leaky_kernel(x, weight, bias, pool)
  want = conv_stack.conv3x3_leaky_plain(x, weight, bias, pool)
  torch.cuda.synchronize()
  rel, err = 0.0, 0.0
  for g, p in zip(got, want):
    if p is None:
      continue
    diff = (g.float() - p.float()).abs().max().item()
    err = max(err, diff)
    rel = max(rel, diff / p.float().abs().max().item())
  result = {
      'shape': f'{batch}x{h}x{w} {cin}->{cout}{"+pool" if pool else ""}',
      'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
      'rel_err': rel, 'bound': bound, 'ok': rel <= bound,
  }
  if timed:
    result['ms'] = time_ms(lambda: conv_stack.conv3x3_leaky_kernel(
        x, weight, bias, pool))
    result['plain_ms'] = time_ms(lambda: conv_stack.conv3x3_leaky_plain(
        x, weight, bias, pool))
  return result


@contextlib.contextmanager
def plain_versions():
  """Routes the model's warp and conv-stack calls to the plain versions."""
  saved = warp.backward_warp, conv_stack.conv3x3_leaky
  warp.backward_warp = warp.backward_warp_plain
  conv_stack.conv3x3_leaky = conv_stack.conv3x3_leaky_plain
  try:
    yield
  finally:
    warp.backward_warp, conv_stack.conv3x3_leaky = saved


def main() -> int:
  parser = argparse.ArgumentParser(description='GPU smoke test of the port.')
  parser.add_argument('--out', default=None,
                      help='Directory for the nvcc report and a JSON of '
                      'every measurement (optional).')
  args = parser.parse_args()
  failures = []

  # Phase 1: the card.
  card = device_line()
  print(card)
  kind = torch.cuda.get_device_name(0)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  # Phase 2: build.
  start = time.perf_counter()
  _kernels.library()
  print(f'build: {time.perf_counter() - start:.1f} s '
        f'(nvcc {_kernels.BUILD_INFO["seconds"]:.1f} s, sm_90a, '
        f'{_kernels.BUILD_INFO["path"]})')

  # Phase 3: each kernel against its plain version at main-path shapes.
  # The warp has two paths: 16-byte channel vectors where C allows them
  # (the flow estimator's C = 64 ... 960) and scalar loads where it does
  # not (the fusion's C = 67 ... 963); each is checked.
  rng = np.random.RandomState(0)
  checks = {
      'warp': [check_warp(rng, 1088, 1920, 67, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 1088, 1920, 64, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 136, 240, 960, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 544, 960, 195, torch.float32,
                          WARP_F32_BOUND)],
      'conv3x3_c64': [], 'conv3x3_wide': [],
  }
  for h, w, cin, cout, pool in ((1088, 1920, 64, 64, True),
                                (544, 960, 128, 128, True),
                                (272, 480, 128, 256, False),
                                (136, 240, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    for dtype, bound in ((torch.bfloat16, CONV_BF16_BOUND),
                         (torch.float32, CONV_F32_BOUND)):
      checks[name].append(check_conv(rng, h, w, cin, cout, pool, dtype,
                                     bound))
  # Edges the main path also reaches: odd extents (the 17x30 coarsest
  # level), batches (patch tiling), both warp paths in f32.
  checks['warp'].append(check_warp(rng, 17, 30, 195, torch.float32,
                                   WARP_F32_BOUND, batch=2, timed=False))
  checks['warp'].append(check_warp(rng, 17, 30, 192, torch.float32,
                                   WARP_F32_BOUND, batch=2, timed=False))
  checks['conv3x3_c64'].append(check_conv(
      rng, 17, 30, 64, 64, False, torch.bfloat16, CONV_BF16_BOUND, batch=2,
      timed=False))
  checks['conv3x3_wide'].append(check_conv(
      rng, 34, 60, 128, 128, True, torch.float32, CONV_F32_BOUND, batch=2,
      timed=False))
  for name, results in checks.items():
    for r in results:
      print(f'kernel {name} {r["shape"]} {r["dtype"]}: max_abs_err '
            f'{r["max_abs_err"]:.3e}' +
            (f' rel_err {r["rel_err"]:.3e}' if 'rel_err' in r else '') +
            f' (bound {r["bound"]:.1e}) {"ok" if r["ok"] else "FAILED"}' +
            (f'; kernel {r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms'
             if 'ms' in r else ''))
      if not r['ok']:
        failures.append(f'{name} {r["shape"]} {r["dtype"]}')

  # Phase 4: the main path, three 1080p pair requests.
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  interpolator = Interpolator(model, options, align=64, device='cuda')
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  dt = np.full((1,), 0.5, np.float32)
  _kernels.reset_launch_counts()
  outputs, seconds = [], []
  for _ in range(REQUESTS):
    start = time.perf_counter()
    outputs.append(interpolator(frames[0], frames[1], dt))
    seconds.append(time.perf_counter() - start)
  launches = _kernels.launch_counts()

  expected = {k: REQUESTS * v for k, v in PAIR_LAUNCHES.items()}
  if launches != expected:
    failures.append(f'launches {launches} != {expected}')
  out = outputs[0]
  if out.shape != (1, 1080, 1920, 3):
    failures.append(f'output shape {out.shape}')
  if not all(np.isfinite(o).all() for o in outputs):
    failures.append('non-finite output')
  repeat_err = max(float(np.abs(o - out).max()) for o in outputs[1:])
  if repeat_err > REPEAT_BOUND:
    failures.append(f'repeated requests differ by {repeat_err:.3e}')

  x0 = torch.from_numpy(frames[0]).cuda()
  x1 = torch.from_numpy(frames[1]).cuda()
  dtd = torch.from_numpy(dt).cuda()
  device_ms = time_ms(lambda: interpolator.call_device(x0, x1, dtd), iters=3)
  with plain_versions():
    _kernels.reset_launch_counts()
    plain_out = interpolator(frames[0], frames[1], dt)
    plain_launches = sum(_kernels.launch_counts().values())
    plain_device_ms = time_ms(
        lambda: interpolator.call_device(x0, x1, dtd), iters=3)
  if plain_launches:
    failures.append(f'plain forward launched {plain_launches} kernels')
  mse = float(np.mean((out.astype(np.float64) - plain_out)**2))
  psnr = 10.0 * np.log10(1.0 / max(mse, 1e-20))
  if not psnr >= PSNR_BOUND_DB:
    failures.append(f'PSNR kernels vs plain {psnr:.2f} dB < {PSNR_BOUND_DB}')
  request_ms = [1e3 * s for s in seconds]
  print(f'main path: {REQUESTS} requests of a 1080p pair (released config, '
        f'bf16 policy), request ms {[round(t, 3) for t in request_ms]}, '
        f'{min(request_ms[1:]):.3f} ms/pair after warm-up (numpy in/out), '
        f'{device_ms:.3f} ms/pair on device (plain versions: '
        f'{plain_device_ms:.3f} ms); launches {launches}; repeat max-abs '
        f'{repeat_err:.1e}; PSNR kernels vs plain {psnr:.2f} dB; on {card}')

  record = {'kernels': []}
  for name in ('warp', 'conv3x3_c64', 'conv3x3_wide'):
    timed = [r for r in checks[name]
             if r['dtype'] == 'bfloat16' and 'ms' in r]
    record['kernels'].append({
        'name': name, 'route': 'cuda', 'source': SOURCES[name],
        'replaces': REPLACES[name], 'launches': launches[name],
        'max_abs_err': max(r['max_abs_err'] for r in timed),
        'ms': sum(r['ms'] for r in timed),
        'plain_ms': sum(r['plain_ms'] for r in timed),
    })

  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke_build.log'), 'w') as f:
      f.write(str(_kernels.BUILD_INFO.get('log', '')))
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump({'card': card, 'checks': checks, 'request_ms': request_ms,
                 'device_ms': device_ms, 'plain_device_ms': plain_device_ms,
                 'launches': launches, 'psnr_db': psnr,
                 'repeat_err': repeat_err, 'failures': failures}, f,
                indent=1)

  if failures:
    print('chip_smoke: FAILED: ' + '; '.join(failures), file=sys.stderr)
    return 1
  print(json.dumps(record))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  try:
    sys.exit(main())
  except CheckFailed as e:
    print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
    sys.exit(1)
