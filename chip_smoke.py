#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

  python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from frame_interpolation_tpu_torch/csrc with
nvcc (one nvcc per source, in parallel) and holds each kernel against its
plain PyTorch version: the forward warp and the conv stacks at the shapes of
the 1080p serving path (the conv also at the train step's shapes, in TF32
and in exact f32), the warp's derivative planes and splat at the training
and 1080p shapes. Each timed check gives the kernel's time, the plain
version's, one PyTorch library call's where one computes the same function
(`library_ms`: F.grid_sample for the warp, the image gradient of its
backward for the splat, F.conv2d with bias through cuDNN for the conv,
which leaves out the activation and the pool), and the
least time the card could take (`bound_ms`: the larger of the FLOPs over
the dtype's peak and the compulsory bytes over 3.35 TB/s). Then it drives
the port's two paths:

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

Between serving and training it drives the video slice through the same
kernels, and after training the eval loop:

  * the exact uint8 rules on the card: u8 -> f32 of all 256 byte values
    bit for bit against numpy's v / 255, and the device quantization of a
    1080p frame against io.images.to_uint8;
  * the frame tree of 3 1080p uint8 frames at T = 3 (17 frames, bf16
    policy): the feature-cached DFS (f32 and uint8 out) and the chunked
    tree (max_batch 3), each with its launch counts, held against each
    other (PSNR), the uint8 output against the host's quantization, the
    kernels against the plain versions, and the streaming driver against
    the frontier; ms per output frame on the device and peak memory per
    route;
  * the tiled tree of a 1080p pair (2x2 patches, T = 1) against the tiled
    pair forward;
  * the eval loop (released config, f32, two 256x448 triplets; metrics
    l1, l2, ssim, psnr and the L1 training loss), kernels against plain
    with TF32 and cuDNN off, and its ms per example.

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
import sys
import tempfile
import time

import numpy as np
import torch

from frame_interpolation_tpu_torch import losses as losses_lib
from frame_interpolation_tpu_torch.inference import (Interpolator,
                                                     cached_tree,
                                                     interpolator as
                                                     interpolator_lib,
                                                     recursion)
from frame_interpolation_tpu_torch.io import images, params_io
from frame_interpolation_tpu_torch.models import create_model, init_params
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack, warp
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import (configs, eval_lib,
                                                    metrics_lib, train_lib)
from frame_interpolation_tpu_torch.utils import measure

WARP_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
WARP_F32_BOUND = 1e-5          # max-abs
CONV_BF16_BOUND = 1e-2         # max|k - p| / max|p|
CONV_F32_BOUND = 1e-4          # same, TF32 off on the plain side
# Same, the kernel in TF32 against the plain version in exact f32: TF32
# keeps 10 of f32's 23 mantissa bits, so each product is off by up to
# about 2^-10 relative; over the sums of 576-4608 terms that leaves about
# 1e-3 of max|p|. Half the bf16 bound.
CONV_TF32_BOUND = 5e-3
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
# The video tree: 3 frames of 1080p, T = 3, so 17 frames and 14 midpoints.
VIDEO_FRAMES, VIDEO_TIMES, VIDEO_MAX_BATCH = 3, 3, 3
VIDEO_H, VIDEO_W = 1080, 1920
VIDEO_OUTPUTS = (VIDEO_FRAMES - 1) * 2**VIDEO_TIMES + 1
# The cached DFS: 22 warps a midpoint; 9 extractions (3 inputs + 6
# midpoints that are not final-depth leaves) of 7 C=64 and 24 wide convs.
CACHED_TREE_LAUNCHES = {'warp': 14 * 22, 'warp_planes': 0, 'splat': 0,
                        'conv3x3_c64': 9 * 7, 'conv3x3_wide': 9 * 24}
# The chunked tree at max_batch 3: 6 forwards (a batch of 2 at depth 1,
# 3+3 and 3+3+3 with filler pairs at depths 2 and 3); a launch covers the
# whole batch, so each forward launches a pair's 22/14/48.
CHUNKED_TREE_LAUNCHES = {k: 6 * v for k, v in PAIR_LAUNCHES.items()}
# The tiled tree of a pair at T = 1 in 2x2 patches: each patch's cached
# tree extracts its 2 frames and makes one midpoint.
TILED_TREE_LAUNCHES = {'warp': 4 * 22, 'warp_planes': 0, 'splat': 0,
                       'conv3x3_c64': 4 * 2 * 7, 'conv3x3_wide': 4 * 2 * 24}
TREE_PSNR_DB = 50.0            # per frame, the same model at other batches
UINT8_LEVELS = 1               # device uint8 vs host quantization, levels
# Eval means, kernels vs plain in exact f32 (TF32 and cuDNN off): the
# forward's outputs agree to about 1e-5 of their range (the conv's f32
# bound is 1e-4 of max|p| a site, and errors average out in the means),
# so each mean moves by about 1e-5 of its size: 1e-4 relative for l1, l2
# and the training loss; 1e-4 absolute for SSIM, whose value lies in
# [-1, 1] and may sit near 0; 1e-3 dB for PSNR (10 log10 of an mse that
# moves by 1e-4 relative is 4e-4 dB).
EVAL_REL_BOUND = 1e-4
EVAL_SSIM_BOUND = 1e-4
EVAL_PSNR_BOUND_DB = 1e-3
EVAL_BATCHES, EVAL_H, EVAL_W = 2, 256, 448
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
  return measure.card_line()


def add_timing(result, kernel_fn, plain_fn, library_fn, flops, nbytes, peak):
  """The four numbers of a timed check, all from this run and this card;
  the card queues each loop (measure.time_ms), so a kernel of a few
  microseconds is timed and not its launch."""
  result['ms'] = measure.time_ms(kernel_fn)
  result['plain_ms'] = measure.time_ms(plain_fn)
  result['library_ms'] = (None if library_fn is None else
                          measure.time_ms(library_fn))
  result.update(measure.roofline(flops, nbytes, peak))
  result['share'] = result['bound_ms'] / result['ms']


@contextlib.contextmanager
def tf32_allowed(allowed: bool):
  """Sets torch.backends.cudnn.allow_tf32, the flag the conv kernel's f32
  route follows (TF32 wgmma or exact FMAs), and restores it."""
  saved = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = allowed
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = saved


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
    # F.grid_sample (bilinear, border, align_corners=True) on the same
    # channels-last image, its grid made from the flow beforehand.
    grid = measure.bilinear_grid(flow).to(dtype)
    nchw = image.permute(0, 3, 1, 2)
    nbytes = 2 * image.numel() * image.element_size() + flow.numel() * 4
    add_timing(result, lambda: warp.backward_warp_kernel(image, flow),
               lambda: warp.backward_warp_plain(image, flow),
               lambda: torch.nn.functional.grid_sample(
                   nchw, grid, mode='bilinear', padding_mode='border',
                   align_corners=True),
               # Three lerps a channel, 3 FLOPs each.
               9.0 * image.numel(), nbytes, measure.PEAK_FLOPS['float32'])
  return result


def check_conv(rng, h, w, cin, cout, pool, dtype, bound, batch=1,
               timed=True, tf32=False):
  """The conv kernel against its plain version in exact f32 (TF32 off); the
  kernel and the library call run with TF32 allowed when `tf32`."""
  x = torch.from_numpy(
      (rng.rand(batch, h, w, cin) * 2 - 1).astype(np.float32))
  x = x.to('cuda', dtype)
  std = (9.0 * cin)**-0.5
  weight = torch.from_numpy(
      (rng.randn(cout, cin, 3, 3) * std).astype(np.float32)).cuda()
  bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda()

  def kernel():
    with tf32_allowed(tf32):
      return conv_stack.conv3x3_leaky_kernel(x, weight, bias, pool)

  def plain():
    return conv_stack.conv3x3_leaky_plain(x, weight, bias, pool)

  got, want = kernel(), plain()
  torch.cuda.synchronize()
  rel, err = 0.0, 0.0
  for g, p in zip(got, want):
    if p is None:
      continue
    diff = (g.float() - p.float()).abs().max().item()
    err = max(err, diff)
    rel = max(rel, diff / p.float().abs().max().item())
  kind = 'tf32' if tf32 and dtype == torch.float32 else str(dtype).split(
      '.')[-1]
  result = {
      'shape': f'{batch}x{h}x{w} {cin}->{cout}{"+pool" if pool else ""}',
      'dtype': kind, 'route': conv_stack.kernel_symbol(dtype, tf32),
      'max_abs_err': err, 'rel_err': rel, 'bound': bound, 'ok': rel <= bound,
  }
  if timed:
    # F.conv2d with bias on channels-last tensors, through cuDNN: the conv
    # and bias only, without the activation and the pool.
    nchw = x.permute(0, 3, 1, 2)
    w_cl = weight.to(dtype).contiguous(memory_format=torch.channels_last)
    b_cl = bias.to(dtype)

    def library():
      with tf32_allowed(tf32):
        return torch.nn.functional.conv2d(nchw, w_cl, b_cl, padding=1)

    add_timing(result, kernel, plain, library,
               *measure.conv_cost(batch, h, w, cin, cout, pool,
                                  x.element_size()),
               measure.PEAK_FLOPS[kind])
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
    # No single PyTorch call computes the planes.
    add_timing(result, lambda: warp.warp_planes_kernel(image, flow),
               lambda: warp.warp_planes_plain(image, flow), None,
               14.0 * image.numel(),
               3 * image.numel() * image.element_size() + flow.numel() * 4,
               measure.PEAK_FLOPS['float32'])
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
    # The library call: the image gradient of grid_sample's backward
    # (bilinear, border, align_corners=True) under the warp's grid, made
    # beforehand. In f32, as the splat's accumulator is, so a bf16 g is
    # widened beforehand; the call also computes the grid's gradient, which
    # reads the image. The bound counts the splat's bytes: g read, the f32
    # accumulator written once.
    grid = measure.bilinear_grid(flow)
    g_nchw = g.float().permute(0, 3, 1, 2)
    image_nchw = torch.zeros_like(g_nchw)

    def library():
      return torch.ops.aten.grid_sampler_2d_backward(
          g_nchw, image_nchw, grid, 0, 1, True, [True, False])[0]

    result['library_rel_err'] = ((library().permute(0, 2, 3, 1) - want).abs(
        ).max() / want.abs().max()).item()
    add_timing(result, lambda: warp.splat_kernel(g, flow),
               lambda: warp.splat_plain(g, flow), library, 8.0 * g.numel(),
               g.numel() * (g.element_size() + 4) + flow.numel() * 4,
               measure.PEAK_FLOPS['float32'])
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
  # flags() allows TF32 unless told otherwise, and the conv kernel's f32
  # route follows that flag: the gate holds exact f32 against exact f32.
  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
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
  # PyTorch's default precision (cuDNN convs may use TF32, and so does the
  # conv kernel: its TF32 wgmma route).
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
        f'{TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP}, f32, TF32 allowed); '
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


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
  mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64))**2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def min_frame_psnr(a: np.ndarray, b: np.ndarray) -> float:
  return min(psnr_db(x, y) for x, y in zip(a, b))


def check_uint8_rules(failures):
  """The exact uint8 rules on the card."""
  values = torch.arange(256, dtype=torch.int32).to(torch.uint8).cuda()
  got = interpolator_lib.u8_to_unit_f32(values).cpu().numpy()
  want = np.arange(256, dtype=np.float32) / np.float32(255)
  wrong = int((got.view(np.uint32) != want.view(np.uint32)).sum())
  # What the rule avoids: true division by 255 on the card.
  naive = (values.float() / 255).cpu().numpy()
  naive_wrong = int((naive.view(np.uint32) != want.view(np.uint32)).sum())
  rng = np.random.RandomState(7)
  frame = (rng.rand(1080, 1920, 3) * 1.4 - 0.2).astype(np.float32)
  frame[0, :256, 0] = (np.arange(256) + 0.5) / np.float32(255)
  frame[1, :6, 0] = [0.0, 1.0, -1.0, 2.0, -0.0, 0.5]
  quantized = cached_tree.quantize_u8(torch.from_numpy(frame).cuda())
  q_wrong = int((quantized.cpu().numpy() != images.to_uint8(frame)).sum())
  if wrong:
    failures.append(f'u8 -> f32: {wrong} of 256 byte values differ')
  if q_wrong:
    failures.append(f'device quantization: {q_wrong} bytes differ')
  print(f'uint8 rules: u8 -> f32 of all 256 byte values {256 - wrong}/256 '
        f'bit-equal to numpy v / 255 (true division on the card: '
        f'{naive_wrong} differ); device quantization of a 1080x1920x3 '
        f'frame in [-0.2, 1.2) with .5 boundaries: {q_wrong} bytes differ '
        f'from io.images.to_uint8')
  return {'u8_wrong': wrong, 'naive_div_wrong': naive_wrong,
          'quantize_wrong': q_wrong}


def run_counted(fn):
  """fn() with the launch counts set to 0 before it; its result, the
  counts just after, and the peak device memory it took."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _kernels.reset_launch_counts()
  out = fn()
  torch.cuda.synchronize()
  return out, _kernels.launch_counts(), torch.cuda.max_memory_allocated()


def check_video(interpolator, card, failures):
  """The frame tree of 3 1080p frames at T = 3, by both routes."""
  frames = np.random.RandomState(0).randint(
      0, 256, (VIDEO_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)
  frames_dev = torch.from_numpy(frames).cuda()
  report, routes = {}, {
      'cached': dict(cached=True),
      'cached_uint8': dict(cached=True, as_uint8=True),
      'chunked': dict(cached=False, max_batch=VIDEO_MAX_BATCH),
  }
  outputs = {}
  for name, kwargs in routes.items():
    out, launches, peak = run_counted(
        lambda: interpolator.expand_tree_device(frames_dev, VIDEO_TIMES,
                                                **kwargs))
    outputs[name] = out.cpu().numpy()
    want = CHUNKED_TREE_LAUNCHES if name == 'chunked' else (
        CACHED_TREE_LAUNCHES)
    if launches != want:
      failures.append(f'{name} tree launches {launches} != {want}')
    # End to end on the card: the host's lag between launches counts.
    ms = measure.time_ms(lambda: interpolator.expand_tree_device(
        frames_dev, VIDEO_TIMES, **kwargs), iters=2, queued=False)
    report[name] = {'launches': launches, 'peak_bytes': peak,
                    'ms': ms, 'ms_per_frame': ms / VIDEO_OUTPUTS}
  cached, chunked = outputs['cached'], outputs['chunked']
  if cached.shape != (VIDEO_OUTPUTS, VIDEO_H, VIDEO_W, 3) or not np.isfinite(
      cached).all():
    failures.append(f'cached tree output {cached.shape}, or not finite')
  if not np.array_equal(cached[::2**VIDEO_TIMES],
                        frames.astype(np.float32) / np.float32(255)):
    failures.append('the cached tree does not carry the input frames')
  chunked_psnr = min_frame_psnr(chunked, cached)
  if not chunked_psnr >= TREE_PSNR_DB:
    failures.append(f'chunked vs cached tree {chunked_psnr:.2f} dB')
  levels = int(np.abs(outputs['cached_uint8'].astype(np.int32) -
                      images.to_uint8(cached).astype(np.int32)).max())
  if levels > UINT8_LEVELS:
    failures.append(f'uint8 tree vs host quantization: {levels} levels')

  with plain_versions():
    plain, plain_launches, _ = run_counted(
        lambda: interpolator.expand_tree_device(frames_dev, VIDEO_TIMES,
                                                cached=True))
  plain_psnr = min_frame_psnr(cached, plain.cpu().numpy())
  if sum(plain_launches.values()):
    failures.append(f'plain tree launched {plain_launches}')
  if not plain_psnr >= PSNR_BOUND_DB:
    failures.append(f'tree kernels vs plain {plain_psnr:.2f} dB')

  # The streaming driver (one pair a chunk, two chunks in flight, fetched
  # on a side stream) against the whole tree's one fetch; host frames.
  inputs = list(frames)
  start = time.perf_counter()
  streamed = list(recursion.interpolate_frontier_streaming(
      inputs, VIDEO_TIMES, interpolator, pairs_per_chunk=1,
      pipeline_depth=2))
  stream_ms = 1e3 * (time.perf_counter() - start)
  whole = recursion.interpolate_frontier(inputs, VIDEO_TIMES, interpolator)
  stream_err = max(float(np.abs(a - b).max())
                   for a, b in zip(streamed, whole))
  if (len(streamed), len(whole)) != (VIDEO_OUTPUTS, VIDEO_OUTPUTS) or (
      stream_err > REPEAT_BOUND):
    failures.append(f'streaming vs frontier: {len(streamed)} frames, '
                    f'max-abs {stream_err:.3e}')
  start = time.perf_counter()
  written = list(recursion.interpolate_frontier_streaming(
      inputs, VIDEO_TIMES, interpolator, pairs_per_chunk=1,
      pipeline_depth=2, as_uint8=True))
  stream_u8_ms = 1e3 * (time.perf_counter() - start)
  if not np.array_equal(np.stack(written), outputs['cached_uint8']):
    failures.append('streaming uint8 frames differ from the uint8 tree')
  for name in routes:
    r = report[name]
    print(f'video tree {name} (3 1080p uint8 frames, T = {VIDEO_TIMES}, '
          f'{VIDEO_OUTPUTS} frames, bf16 policy): '
          f'{r["ms_per_frame"]:.3f} ms per output frame on the device '
          f'({r["ms"]:.3f} ms a tree), peak memory '
          f'{r["peak_bytes"] / 2**30:.2f} GiB, launches {r["launches"]}')
  print(f'video tree checks: chunked vs cached min frame PSNR '
        f'{chunked_psnr:.2f} dB (bound {TREE_PSNR_DB}); uint8 vs host '
        f'quantization {levels} levels (bound {UINT8_LEVELS}); kernels vs '
        f'plain over the cached tree {plain_psnr:.2f} dB (bound '
        f'{PSNR_BOUND_DB}); streaming (1 pair a chunk, depth 2) vs frontier '
        f'max-abs {stream_err:.1e} (bound {REPEAT_BOUND:.0e}), '
        f'{stream_ms / VIDEO_OUTPUTS:.3f} ms per frame on the host clock, '
        f'{stream_u8_ms / VIDEO_OUTPUTS:.3f} as uint8; on {card}')
  report.update(chunked_psnr=chunked_psnr, uint8_levels=levels,
                plain_psnr=plain_psnr, stream_err=stream_err,
                stream_ms_per_frame=stream_ms / VIDEO_OUTPUTS,
                stream_uint8_ms_per_frame=stream_u8_ms / VIDEO_OUTPUTS)
  return report


def check_tiled_tree(model, options, card, failures):
  """The tiled tree of a 1080p pair (2x2 patches, T = 1) against the
  tiled pair forward."""
  tiled = Interpolator(model, options, align=64, block_shape=(2, 2),
                       device='cuda')
  frames = np.random.RandomState(1).rand(2, VIDEO_H, VIDEO_W, 3).astype(
      np.float32)
  frames_dev = torch.from_numpy(frames).cuda()
  tree, launches, peak = run_counted(
      lambda: tiled.expand_tree_device(frames_dev, 1))
  tree = tree.cpu().numpy()
  ms = measure.time_ms(lambda: tiled.expand_tree_device(frames_dev, 1),
                       iters=2, queued=False)
  pair = tiled(frames[:1], frames[1:], np.full((1,), 0.5, np.float32))[0]
  psnr = psnr_db(tree[1], pair)
  if launches != TILED_TREE_LAUNCHES:
    failures.append(f'tiled tree launches {launches} != '
                    f'{TILED_TREE_LAUNCHES}')
  if tree.shape != (3, VIDEO_H, VIDEO_W, 3) or not psnr >= TREE_PSNR_DB:
    failures.append(f'tiled tree {tree.shape}, {psnr:.2f} dB vs the pair')
  print(f'tiled tree (a 1080p pair, 2x2 patches, T = 1): {psnr:.2f} dB vs '
        f'the tiled pair forward (bound {TREE_PSNR_DB}); {ms:.3f} ms a '
        f'tree, peak memory {peak / 2**30:.2f} GiB; launches {launches}; '
        f'on {card}')
  return {'psnr': psnr, 'launches': launches, 'ms': ms, 'peak_bytes': peak}


def check_eval(card, failures):
  """eval_lib.eval_loop, kernels vs plain in exact f32."""
  config = configs.get_experiment('film_net-L1')
  options = config.model
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  metrics = metrics_lib.create_metrics_fns(
      losses_lib.test_losses(['l1', 'l2', 'ssim', 'psnr']),
      losses_lib.training_losses(['l1']))
  rng = np.random.RandomState(5)
  datasets = {'vimeo_like': []}
  for _ in range(EVAL_BATCHES):
    frames = rng.rand(3, 1, EVAL_H, EVAL_W, 3).astype(np.float32)
    datasets['vimeo_like'].append({
        'x0': frames[0], 'y': frames[1], 'x1': frames[2],
        'time': np.full((1, 1), 0.5, np.float32)})

  def run():
    return eval_lib.eval_loop(model, datasets, metrics, 0,
                              log_fn=lambda _: None)['vimeo_like']

  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
    got, launches, _ = run_counted(run)
    ms = measure.time_ms(run, iters=2, queued=False) / EVAL_BATCHES
    with plain_versions():
      want, plain_launches, _ = run_counted(run)
  errors = {}
  for name, value in want.items():
    diff = abs(got[name] - value)
    if name == 'psnr':
      errors[name], ok = diff, diff <= EVAL_PSNR_BOUND_DB
    elif name == 'ssim':
      errors[name], ok = diff, diff <= EVAL_SSIM_BOUND
    else:
      errors[name] = diff / abs(value)
      ok = errors[name] <= EVAL_REL_BOUND
    if not ok:
      failures.append(f'eval {name}: {got[name]} kernels, {value} plain')
  want_launches = {k: EVAL_BATCHES * v for k, v in PAIR_LAUNCHES.items()}
  if launches != want_launches:
    failures.append(f'eval launches {launches} != {want_launches}')
  if sum(plain_launches.values()):
    failures.append(f'plain eval launched {plain_launches}')
  print(f'eval loop (released config, f32, TF32 and cuDNN off, '
        f'{EVAL_BATCHES} batches of one {EVAL_H}x{EVAL_W} triplet): '
        f'kernels {got}, plain {want}; errors {errors} (bounds: '
        f'{EVAL_REL_BOUND:.0e} relative, SSIM {EVAL_SSIM_BOUND:.0e}, PSNR '
        f'{EVAL_PSNR_BOUND_DB:.0e} dB); {ms:.3f} ms per example; launches '
        f'{launches}; on {card}')
  return {'kernels': got, 'plain': want, 'errors': errors, 'launches':
          launches, 'ms_per_example': ms}


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
  # The warp has two routes: 16-byte channel vectors where C allows them
  # (the flow estimator's C = 64 ... 960) and runs of flat (pixel, channel)
  # elements where it does not (the fusion's C = 67 ... 963); each is
  # checked, the run route also at the train step's two finest fusion
  # warps.
  rng = np.random.RandomState(0)
  checks = {
      'warp': [check_warp(rng, 1088, 1920, 67, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 1088, 1920, 64, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 136, 240, 960, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 544, 960, 195, torch.float32,
                          WARP_F32_BOUND),
               check_warp(rng, 256, 256, 67, torch.float32,
                          WARP_F32_BOUND, batch=TRAIN_BATCH),
               check_warp(rng, 128, 128, 195, torch.float32,
                          WARP_F32_BOUND, batch=TRAIN_BATCH)],
      'conv3x3_c64': [], 'conv3x3_wide': [],
  }
  # The conv at every distinct serving site shape in bf16 (timed), and at
  # four of them in exact f32 (TF32 off).
  for h, w, cin, cout, pool in ((1088, 1920, 64, 64, True),
                                (544, 960, 128, 128, True),
                                (272, 480, 128, 256, False),
                                (272, 480, 256, 256, True),
                                (136, 240, 256, 512, False),
                                (136, 240, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    checks[name].append(check_conv(rng, h, w, cin, cout, pool,
                                   torch.bfloat16, CONV_BF16_BOUND))
    if (h, cin, cout) in ((1088, 64, 64), (544, 128, 128), (272, 128, 256),
                          (136, 512, 512)):
      checks[name].append(check_conv(rng, h, w, cin, cout, pool,
                                     torch.float32, CONV_F32_BOUND))
  # The train step's conv shapes (f32, batch 8 of 256x256): TF32 allowed,
  # as PyTorch's default has it, and TF32 off.
  for h, cin, cout, pool in ((256, 64, 64, True), (32, 256, 512, False),
                             (16, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    for tf32, bound in ((True, CONV_TF32_BOUND), (False, CONV_F32_BOUND)):
      checks[name].append(check_conv(rng, h, h, cin, cout, pool,
                                     torch.float32, bound, batch=TRAIN_BATCH,
                                     tf32=tf32))
  # Edges the main path also reaches: odd extents (the 17x30 coarsest
  # level, 34x60 next to it), batches (patch tiling), both warp paths in f32.
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
  for h, w, c in ((17, 30, 64), (34, 60, 128)):
    name = 'conv3x3_c64' if c == 64 else 'conv3x3_wide'
    for dtype, bound, tf32 in ((torch.bfloat16, CONV_BF16_BOUND, False),
                               (torch.float32, CONV_TF32_BOUND, True)):
      checks[name].append(check_conv(rng, h, w, c, c, True, dtype, bound,
                                     batch=2, timed=False, tf32=tf32))
  # The training backward's kernels: the warp's derivative planes (B4) and
  # the splat (B5/B6), at shapes of the film_net-L1 train step (f32, batch
  # 8 of 256x256 crops: the two finest fusion warps, a middle and a coarse
  # flow-estimator warp) and at 1080p in bf16, each with four flows; timed
  # with the seam flow, and the splat also with the oob flow at the finest
  # fusion warp, where every tile takes its global-atomic route.
  checks['warp_planes'], checks['splat'] = [], []
  for b, h, w, c, dtype in ((8, 256, 256, 67, torch.float32),
                            (8, 128, 128, 195, torch.float32),
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
          SPLAT_F32_BOUND if f32 else SPLAT_BF16_BOUND, flow_kind,
          timed or (flow_kind == 'oob' and (h, c) == (256, 67))))
  for name, results in checks.items():
    for r in results:
      flow_kind = f' {r["flow"]} flow' if 'flow' in r else ''
      library = ('none' if r.get('library_ms') is None else
                 f'{r["library_ms"]:.3f} ms')
      print(f'kernel {name} {r["shape"]} {r["dtype"]}{flow_kind}: max_abs_err '
            f'{r["max_abs_err"]:.3e}' +
            (f' rel_err {r["rel_err"]:.3e}' if 'rel_err' in r else '') +
            (f' (library rel_err {r["library_rel_err"]:.1e})'
             if 'library_rel_err' in r else '') +
            f' (bound {r["bound"]:.1e}) {"ok" if r["ok"] else "FAILED"}' +
            (f'; kernel {r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, '
             f'library {library}, bound {r["bound_ms"]:.3f} ms '
             f'({r["bound_by"]}), share {r["share"]:.3f}'
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
  # End to end: the host's lag between launches counts, so the card does
  # not queue the loop first.
  device_ms = measure.time_ms(lambda: interpolator.call_device(x0, x1, dtd),
                              iters=3, queued=False)
  with plain_versions():
    _kernels.reset_launch_counts()
    plain_out = interpolator(frames[0], frames[1], dt)
    plain_launches = sum(_kernels.launch_counts().values())
    plain_device_ms = measure.time_ms(
        lambda: interpolator.call_device(x0, x1, dtd), iters=3, queued=False)
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

  # Phase 5: the video slice: the exact uint8 rules, the frame tree by both
  # routes, the tiled tree.
  uint8_report = check_uint8_rules(failures)
  video_report = check_video(interpolator, card, failures)
  tiled_report = check_tiled_tree(model, options, card, failures)
  del interpolator, model

  # Phase 6: the training path.
  train_report, train_launches = check_training(card, failures)

  # Phase 7: the eval loop.
  eval_report = check_eval(card, failures)

  # Launches: the serving run's for the forward kernels, the 20-step
  # training run's for the backward ones. Times: the serving kernels' bf16
  # shapes, the backward kernels' every timed shape.
  record = {'kernels': []}
  for name in ('warp', 'warp_planes', 'splat', 'conv3x3_c64',
               'conv3x3_wide'):
    backward = name in ('warp_planes', 'splat')
    timed = [r for r in checks[name]
             if 'ms' in r and (backward or r['dtype'] == 'bfloat16')]
    libraries = [r['library_ms'] for r in timed]
    ops_ms = sum(r['bound_ops_ms'] for r in timed)
    bytes_ms = sum(r['bound_bytes_ms'] for r in timed)
    record['kernels'].append({
        'name': name, 'route': 'cuda', 'source': SOURCES[name],
        'replaces': REPLACES[name],
        'launches': (train_launches if backward else launches)[name],
        'max_abs_err': max(r['max_abs_err'] for r in timed),
        'ms': sum(r['ms'] for r in timed),
        'plain_ms': sum(r['plain_ms'] for r in timed),
        'bound_ms': sum(r['bound_ms'] for r in timed),
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': (None if None in libraries else sum(libraries)),
    })

  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke_build.log'), 'w') as f:
      f.write(str(_kernels.BUILD_INFO.get('log', '')))
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump({'card': card, 'checks': checks, 'request_ms': request_ms,
                 'device_ms': device_ms, 'plain_device_ms': plain_device_ms,
                 'launches': launches, 'psnr_db': psnr,
                 'repeat_err': repeat_err, 'uint8': uint8_report,
                 'video': video_report, 'tiled_tree': tiled_report,
                 'training': train_report, 'eval': eval_report,
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
