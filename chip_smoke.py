#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

  python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from frame_interpolation_tpu_torch/csrc with
nvcc (one nvcc per source, in parallel) and holds each kernel against its
plain PyTorch version: the forward warp and the conv stacks at the shapes of
the 1080p serving path, the warp's derivative planes and splat at the
training and 1080p shapes. Then it drives the port's two paths:

  * serving: three 1080p pair requests through the Interpolator (released
    config, bf16 policy, seeded random weights), checked for shape,
    finiteness, repeatability, the launch counts, and agreement with the
    same forward through the plain versions;
  * training (film_net-L1: released config, f32, batch 8 of 256x256
    moving-square triplets): one train step's loss and gradients against
    the same step through the plain versions (TF32 and cuDNN off), with
    every parameter's gradient finite and non-zero; the launch counts of one
    step; steps/s with the kernels and plain; then `train_lib.train` for
    20 steps with the augmentations and a resume to 25, checked for finite
    losses, checkpoints written and restored, and an export that the
    Interpolator loads.

Each phase prints its lines; the second-to-last line is the per-kernel JSON
record and the last line is {"ok": true, "device": {...}}. Any failed check
exits non-zero before that line. Needs a GPU: without one it exits non-zero
and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from frame_interpolation_tpu_torch import losses as losses_lib
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import create_model, init_params
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack, warp
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import configs, train_lib

WARP_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
WARP_F32_BOUND = 1e-5          # max-abs
CONV_BF16_BOUND = 1e-2         # max|k - p| / max|p|
CONV_F32_BOUND = 1e-4          # same, TF32 off on the plain side
PLANES_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
PLANES_F32_BOUND = 1e-5          # max-abs
SPLAT_BF16_BOUND = 1e-2        # max|k - p| / max|p|, bf16 cotangent
SPLAT_F32_BOUND = 1e-5         # same, f32 cotangent
PSNR_BOUND_DB = 30.0           # kernels vs plain versions, whole forward
REPEAT_BOUND = 1e-6            # max-abs between repeated requests
LOSS_REL_BOUND = 1e-5          # train step, kernels vs plain (TF32 off)
GRAD_REL_BOUND = 1e-3          # per tensor max|g_k - g_p| / max|g_p|
REQUESTS = 3
# Launches per 1080p pair (released config): 12 flow-estimator warps + 10
# fusion warps; per frame 7 C=64 second convs and 15 wider second convs +
# 9 rectangular first convs, and each frame is extracted separately.
PAIR_LAUNCHES = {'warp': 22, 'warp_planes': 0, 'splat': 0,
                 'conv3x3_c64': 14, 'conv3x3_wide': 48}
# Launches per train step: the forward's, plus one planes and one splat
# launch per warp in the backward (every warp's image and flow need a
# gradient); the conv backward is plain PyTorch.
STEP_LAUNCHES = {'warp': 22, 'warp_planes': 22, 'splat': 22,
                 'conv3x3_c64': 14, 'conv3x3_wide': 48}
TRAIN_BATCH, TRAIN_CROP = 8, 256
TRAIN_STEPS, RESUME_STEPS, SAVE_INTERVAL = 20, 25, 10
WARMUP_STEPS, TIMED_STEPS = 3, 10
REPLACES = {
    'warp': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'warp_planes': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'splat': 'frame_interpolation_tpu/ops/warp_splat.py:67',
    'conv3x3_c64': 'frame_interpolation_tpu/ops/conv_stack.py:141',
    'conv3x3_wide': 'frame_interpolation_tpu/ops/conv_stack_wide.py:124',
}
SOURCES = {
    'warp': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'warp_planes': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'splat': 'frame_interpolation_tpu_torch/csrc/splat.cu',
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


def training_flow(kind: str, b: int, h: int, w: int) -> torch.Tensor:
  """The flows the backward kernels are checked with.

  seam: the smooth-seam flow; large: the same plus a displacement of about
  a third of the frame; oob: uniform in +-1.5 frames, so most taps clamp;
  integer: the seam flow rounded, so every raw offset is exactly 0 (and
  the last row and column exactly 1): the clip gradient's 0.5 ties.
  """
  flow = smooth_seam_flow(h, w).expand(b, h, w, 2)
  if kind == 'large':
    flow = flow + torch.tensor([0.37 * w, -0.29 * h], device='cuda')
  elif kind == 'oob':
    rng = np.random.RandomState(h + w)
    flow = torch.from_numpy(((rng.rand(b, h, w, 2) - 0.5) * 3.0 *
                             max(h, w)).astype(np.float32)).cuda()
  elif kind == 'integer':
    flow = torch.round(flow)
  return flow.contiguous()


def check_planes(rng, b, h, w, c, dtype, bound, flow_kind, timed):
  image = torch.from_numpy(rng.rand(b, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flow = training_flow(flow_kind, b, h, w)
  got = warp.warp_planes_kernel(image, flow)
  want = warp.warp_planes_plain(image, flow)
  torch.cuda.synchronize()
  err = max((g.float() - p.float()).abs().max().item()
            for g, p in zip(got, want))
  result = {'shape': f'{b}x{h}x{w}x{c}', 'flow': flow_kind,
            'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
            'bound': bound, 'ok': err <= bound}
  if timed:
    result['ms'] = time_ms(lambda: warp.warp_planes_kernel(image, flow))
    result['plain_ms'] = time_ms(lambda: warp.warp_planes_plain(image, flow))
  return result


def check_splat(rng, b, h, w, c, dtype, bound, flow_kind, timed):
  g = torch.from_numpy((rng.rand(b, h, w, c) - 0.5).astype(np.float32)).to(
      'cuda', dtype)
  flow = training_flow(flow_kind, b, h, w)
  got = warp.splat_kernel(g, flow)
  want = warp.splat_plain(g, flow)
  torch.cuda.synchronize()
  err = (got - want).abs().max().item()
  rel = err / want.abs().max().item()
  result = {'shape': f'{b}x{h}x{w}x{c}', 'flow': flow_kind,
            'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
            'rel_err': rel, 'bound': bound, 'ok': rel <= bound}
  if timed:
    result['ms'] = time_ms(lambda: warp.splat_kernel(g, flow))
    result['plain_ms'] = time_ms(lambda: warp.splat_plain(g, flow))
  return result


def _plain_warp(image, flow):
  return warp.BackwardWarp.apply(image, flow, True)


def _plain_conv(x, weight, bias, pool=False, negative_slope=0.2):
  out = conv_stack.Conv3x3Leaky.apply(x, weight, bias, pool, negative_slope,
                                      True)
  return out if pool else (out, None)


@contextlib.contextmanager
def plain_versions():
  """Routes the model's warp and conv-stack calls to the plain versions,
  forward and backward (the same autograd Functions, plain=True)."""
  saved = warp.backward_warp, conv_stack.conv3x3_leaky
  warp.backward_warp = _plain_warp
  conv_stack.conv3x3_leaky = _plain_conv
  try:
    yield
  finally:
    warp.backward_warp, conv_stack.conv3x3_leaky = saved


def square_frame(cy, cx, size=TRAIN_CROP, half=32):
  frame = np.zeros((size, size, 3), np.float32)
  y0, y1 = int(cy - half), int(cy + half)
  x0, x1 = int(cx - half), int(cx + half)
  frame[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1.0
  return frame


def square_batch(rng, n=TRAIN_BATCH, size=TRAIN_CROP):
  """Moving-square triplets (tests/test_learning.py's pattern, 8x scale):
  a bright square on black, x0 and x1 its endpoints, y its midpoint."""
  x0s, x1s, ys = [], [], []
  for _ in range(n):
    cy, cx = rng.uniform(80, size - 80, size=2)
    dy, dx = rng.uniform(-24, 24, size=2)
    x0s.append(square_frame(cy - dy, cx - dx))
    ys.append(square_frame(cy, cx))
    x1s.append(square_frame(cy + dy, cx + dx))
  return {'x0': np.stack(x0s), 'x1': np.stack(x1s), 'y': np.stack(ys),
          'time': np.full((n, 1), 0.5, np.float32)}


def square_batches(seed):
  rng = np.random.RandomState(seed)
  while True:
    yield square_batch(rng)


def loss_and_grads(model, batch):
  model.zero_grad(set_to_none=True)
  out = model(batch['x0'], batch['x1'], batch['time'])
  loss = losses_lib.l1_loss(batch, out)
  loss.backward()
  grads = {n: None if p.grad is None else p.grad.detach().clone()
           for n, p in model.named_parameters()}
  return loss.item(), grads


def steps_per_second(state, step_fn, batches) -> float:
  """Mean steps/s over TIMED_STEPS steps after WARMUP_STEPS, host clock."""
  for _ in range(WARMUP_STEPS):
    step_fn(state, next(batches), torch.Generator())
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(TIMED_STEPS):
    step_fn(state, next(batches), torch.Generator())
  torch.cuda.synchronize()
  return TIMED_STEPS / (time.perf_counter() - start)


def check_training(card, failures):
  """The training path: step parity, launch counts, speed, the loop."""
  config = configs.get_experiment('film_net-L1')
  options = config.model
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  n_params = sum(p.numel() for p in model.parameters())
  batch = train_lib.batch_to_device(square_batch(np.random.RandomState(1)),
                               torch.device('cuda'))
  report = {}

  # One step's loss and gradients, kernels vs plain, TF32 off and cuDNN
  # off in both: cuDNN's f32 algorithms leave residues of either sign
  # where a conv's true output is exactly 0 (the squares' black
  # background), which flips leaky relu's tie at 0 between two runs whose
  # inputs differ by rounding; PyTorch's own convs keep exact zeros.
  with torch.backends.cudnn.flags(enabled=False):
    _kernels.reset_launch_counts()
    loss_k, grads_k = loss_and_grads(model, batch)
    step_launches = _kernels.launch_counts()
    with plain_versions():
      loss_p, grads_p = loss_and_grads(model, batch)
  plain_launches = sum(_kernels.launch_counts().values()) - sum(
      step_launches.values())
  loss_rel = abs(loss_k - loss_p) / abs(loss_p)
  grad_rel, worst, bad = {}, ('', 0.0), []
  for name, gk in grads_k.items():
    gp = grads_p[name]
    if (gk is None or not torch.isfinite(gk).all() or
        not gk.abs().max().item() > 0):
      bad.append(name)
      continue
    rel = ((gk - gp).abs().max() / gp.abs().max()).item()
    grad_rel[name] = rel
    if rel > worst[1]:
      worst = (name, rel)
  if len(grads_k) != 82 or bad:
    failures.append(f'train step: {len(grads_k)} parameter tensors, '
                    f'without a finite non-zero gradient: {bad}')
  if not loss_rel <= LOSS_REL_BOUND:
    failures.append(f'train step loss rel err {loss_rel:.3e}')
  if not worst[1] <= GRAD_REL_BOUND:
    failures.append(f'train step grad rel err {worst[1]:.3e} ({worst[0]})')
  if step_launches != STEP_LAUNCHES:
    failures.append(f'launches per train step {step_launches} != '
                    f'{STEP_LAUNCHES}')
  if plain_launches:
    failures.append(f'plain train step launched {plain_launches} kernels')
  print(f'train step (film_net-L1, released config {n_params} parameters, '
        f'f32, TF32 and cuDNN off, batch '
        f'{TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP} '
        f'moving squares): loss {loss_k:.7f} kernels, {loss_p:.7f} plain, '
        f'rel err {loss_rel:.2e} (bound {LOSS_REL_BOUND:.0e}); '
        f'{len(grads_k) - len(bad)}/{len(grads_k)} gradients finite and '
        f'non-zero; worst grad rel err {worst[1]:.3e} ({worst[0]}, bound '
        f'{GRAD_REL_BOUND:.0e}); launches per step {step_launches}')
  report.update(loss_kernels=loss_k, loss_plain=loss_p, loss_rel=loss_rel,
                grad_rel=grad_rel, step_launches=step_launches)

  # Steps/s with the kernels and plain: the trainer's lean step (Adam,
  # staircase schedule), batches made in memory, no augmentation;
  # PyTorch's default precision (cuDNN convs may use TF32).
  torch.backends.cudnn.allow_tf32 = True
  opts = train_lib.TrainingOptions()
  step_fn = train_lib.make_train_step(
      losses_lib.training_losses(['l1']), opts, with_summaries=False)
  batches = (train_lib.batch_to_device(b, torch.device('cuda'))
             for b in square_batches(2))
  torch.cuda.reset_peak_memory_stats()
  state = train_lib.create_train_state(model, opts)
  rate_k = steps_per_second(state, step_fn, batches)
  peak_k = torch.cuda.max_memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  with plain_versions():
    rate_p = steps_per_second(state, step_fn, batches)
  peak_p = torch.cuda.max_memory_allocated()
  print(f'train speed: {rate_k:.3f} steps/s with the kernels, {rate_p:.3f} '
        f'plain (mean of {TIMED_STEPS} steps after {WARMUP_STEPS}, batch '
        f'{TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP}, f32, cuDNN TF32 allowed); '
        f'peak memory {peak_k / 2**30:.2f} GiB kernels, '
        f'{peak_p / 2**30:.2f} GiB plain; on {card}')
  report.update(steps_per_s=rate_k, plain_steps_per_s=rate_p,
                peak_bytes=peak_k, plain_peak_bytes=peak_p)
  del state, model, grads_k, grads_p

  # train_lib.train: 20 steps with the augmentations, then a resume to 25.
  with tempfile.TemporaryDirectory() as run_dir:
    runs = []
    for num_steps in (TRAIN_STEPS, RESUME_STEPS):
      lines = []
      opts = train_lib.TrainingOptions(
          num_steps=num_steps, save_interval=SAVE_INTERVAL,
          timing_interval=SAVE_INTERVAL)
      _kernels.reset_launch_counts()
      start = time.perf_counter()
      state = train_lib.train(
          create_model(options), options,
          losses_lib.training_losses(['l1']), square_batches(3), opts,
          run_dir, device='cuda',
          augmentation_names=tuple(config.augmentations),
          log_fn=lines.append)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
      runs.append({'steps': state.step, 'seconds': seconds, 'log': lines,
                   'launches': _kernels.launch_counts(),
                   'checkpoints': train_lib.CheckpointManager(
                       os.path.join(run_dir, 'train')).steps()})
      del state
    first, resumed = runs
    losses = [float(v) for r in runs for line in r['log']
              for v in re.findall(r'training_loss=([-+.\deE]+|nan|inf)',
                                  line)]
    state_dict, exported = params_io.load_state_bundle(
        os.path.join(run_dir, 'saved_model'))
    interpolator = Interpolator(state_dict, exported, align=64,
                                device='cuda')
    frames = square_batch(np.random.RandomState(4), n=1)
    mid = interpolator(frames['x0'], frames['x1'], np.full((1,), 0.5,
                                                           np.float32))
  if first['launches'] != {k: TRAIN_STEPS * v
                           for k, v in STEP_LAUNCHES.items()}:
    failures.append(f'train launches {first["launches"]}')
  if resumed['launches'] != {k: (RESUME_STEPS - TRAIN_STEPS) * v
                             for k, v in STEP_LAUNCHES.items()}:
    failures.append(f'resumed train launches {resumed["launches"]}')
  if len(losses) != 3 or not all(np.isfinite(losses)):
    failures.append(f'train losses {losses}')
  if first['checkpoints'] != [10, 20] or resumed['checkpoints'] != [
      10, 20, 25]:
    failures.append(f'checkpoints {first["checkpoints"]} then '
                    f'{resumed["checkpoints"]}')
  if f'Restored checkpoint at step {TRAIN_STEPS}' not in resumed['log']:
    failures.append('the resumed run did not restore step 20')
  if exported != options or mid.shape != (1, TRAIN_CROP, TRAIN_CROP, 3) or (
      not np.isfinite(mid).all()):
    failures.append('the exported weights did not serve a finite frame')
  print(f'train loop: train_lib.train for {TRAIN_STEPS} steps with '
        f'{list(config.augmentations)} in {first["seconds"]:.1f} s, '
        f'checkpoints {first["checkpoints"]}; resumed to {RESUME_STEPS} in '
        f'{resumed["seconds"]:.1f} s, checkpoints {resumed["checkpoints"]}; '
        f'training_loss at steps 10/20/25 {losses}; launches '
        f'{first["launches"]} then {resumed["launches"]}; the export serves '
        f'a finite {mid.shape} frame')
  report.update(train_runs=runs, train_losses=losses)
  return report, first['launches']


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
  # The training backward's kernels: the warp's derivative planes (B4) and
  # the splat (B5/B6), at shapes of the film_net-L1 train step (f32, batch
  # 8 of 256x256 crops: the finest fusion warp, a middle and a coarse
  # flow-estimator warp) and at 1080p in bf16, each with four flows; timed
  # with the seam flow.
  checks['warp_planes'], checks['splat'] = [], []
  for b, h, w, c, dtype in ((8, 256, 256, 67, torch.float32),
                            (8, 128, 128, 192, torch.float32),
                            (8, 32, 32, 960, torch.float32),
                            (1, 1088, 1920, 64, torch.bfloat16),
                            (1, 1088, 1920, 67, torch.bfloat16)):
    f32 = dtype == torch.float32
    for flow_kind in ('seam', 'large', 'oob', 'integer'):
      timed = flow_kind == 'seam'
      checks['warp_planes'].append(check_planes(
          rng, b, h, w, c, dtype,
          PLANES_F32_BOUND if f32 else PLANES_BF16_BOUND, flow_kind, timed))
      checks['splat'].append(check_splat(
          rng, b, h, w, c, dtype,
          SPLAT_F32_BOUND if f32 else SPLAT_BF16_BOUND, flow_kind, timed))
  for name, results in checks.items():
    for r in results:
      flow_kind = f' {r["flow"]} flow' if 'flow' in r else ''
      print(f'kernel {name} {r["shape"]} {r["dtype"]}{flow_kind}: max_abs_err '
            f'{r["max_abs_err"]:.3e}' +
            (f' rel_err {r["rel_err"]:.3e}' if 'rel_err' in r else '') +
            f' (bound {r["bound"]:.1e}) {"ok" if r["ok"] else "FAILED"}' +
            (f'; kernel {r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms'
             if 'ms' in r else ''))
      if not r['ok']:
        failures.append(f'{name} {r["shape"]} {r["dtype"]}{flow_kind}')

  # Phase 4: the serving path, three 1080p pair requests.
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
  print(f'serving path: {REQUESTS} requests of a 1080p pair (released config, '
        f'bf16 policy), request ms {[round(t, 3) for t in request_ms]}, '
        f'{min(request_ms[1:]):.3f} ms/pair after warm-up (numpy in/out), '
        f'{device_ms:.3f} ms/pair on device (plain versions: '
        f'{plain_device_ms:.3f} ms); launches {launches}; repeat max-abs '
        f'{repeat_err:.1e}; PSNR kernels vs plain {psnr:.2f} dB; on {card}')

  # Phase 5: the training path.
  train_report, train_launches = check_training(card, failures)

  # Launches: the serving run's for the forward kernels, the 20-step
  # training run's for the backward ones. Times: the serving kernels' bf16
  # shapes, the backward kernels' every timed shape.
  record = {'kernels': []}
  for name in ('warp', 'warp_planes', 'splat', 'conv3x3_c64',
               'conv3x3_wide'):
    backward = name in ('warp_planes', 'splat')
    timed = [r for r in checks[name]
             if 'ms' in r and (backward or r['dtype'] == 'bfloat16')]
    record['kernels'].append({
        'name': name, 'route': 'cuda', 'source': SOURCES[name],
        'replaces': REPLACES[name],
        'launches': (train_launches if backward else launches)[name],
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
                 'repeat_err': repeat_err, 'training': train_report,
                 'failures': failures}, f, indent=1)

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
