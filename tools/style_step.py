#!/usr/bin/env python3
"""The film_net-Style step and eval batch: VGG-19 towers, speed, memory.

  python3 tools/style_step.py [--out DIR]

Released config, f32, batch 8 of 256x256 moving squares, PyTorch's
default precision (cuDNN may use TF32), VGG-19 to conv5_2 at its true
widths from a seeded .mat, step 1,500,001 (l1 1, vgg 0.25, style 40).
Reports:

  * the towers a step and an eval batch run (calls of
    `losses.vgg19.vgg_features`, with their grad mode);
  * lean train steps/s as CUDA graphs (train_lib.make_train_step, the
    mean of 20 steps after 3, host clock), film_net-Style and
    film_net-L1, each step's device ms by CUDA events, the peak memory of
    an eager Style step and the Style graph's pool bytes;
  * the Style losses' share of a step: the forward and image backward of
    vgg alone, style alone and both through
    `losses.compute_weighted_loss`, by CUDA events;
  * a Style eval batch: `eval_lib.eval_loop` over 20 batches with the
    l1, vgg and style test losses and the Style training loss, as a
    captured program (its warm-up and capture included), ms a batch,
    three loops.

It imports the port from the checkout it sits in and only entry points
that the port has had since its programs were captured, so a copy placed
in an unpacked older checkout's tools/ measures that checkout in the same
call. Prints the card and its power limit; `--out` keeps a JSON of every
number. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch import losses as losses_lib  # noqa: E402
from frame_interpolation_tpu_torch.losses import vgg19  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.training import (  # noqa: E402
    configs, eval_lib, metrics_lib, train_lib)

BATCH, CROP = 8, 256
STYLE_STEP = 1500001
WARMUP_STEPS, TIMED_STEPS = 3, 20
EVAL_BATCHES, EVAL_LOOPS = 20, 3
# VGG-19's conv widths to conv5_2.
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512, 512)


def card_line() -> str:
  if not torch.cuda.is_available():
    raise SystemExit('style_step: torch.cuda.is_available() is false; this '
                     'script needs a CUDA GPU')
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return query.stdout.strip().splitlines()[0]


def write_vgg_mat(path: str, seed: int = 0) -> None:
  """He-scaled seeded weights at VGG-19's widths (chip_smoke.py's)."""
  rng = np.random.RandomState(seed)
  cin, kernels = 3, []
  for cout in VGG_CHANNELS:
    kernels.append(
        ((rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin))**0.5).astype(
            np.float32), (rng.randn(cout) * 0.1).astype(np.float32)))
    cin = cout
  vgg19.save_vgg_weights(path, kernels)


def square_batch(rng, n=BATCH, size=CROP):
  """Moving-square triplets (chip_smoke.py's pattern)."""
  def frame(cy, cx, half=32):
    out = np.zeros((size, size, 3), np.float32)
    y0, y1, x0, x1 = (int(v) for v in (cy - half, cy + half, cx - half,
                                       cx + half))
    out[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1.0
    return out
  x0s, x1s, ys = [], [], []
  for _ in range(n):
    cy, cx = rng.uniform(80, size - 80, size=2)
    dy, dx = rng.uniform(-24, 24, size=2)
    x0s.append(frame(cy - dy, cx - dx))
    ys.append(frame(cy, cx))
    x1s.append(frame(cy + dy, cx + dx))
  return {'x0': np.stack(x0s), 'x1': np.stack(x1s), 'y': np.stack(ys),
          'time': np.full((n, 1), 0.5, np.float32)}


def events_ms(fn, iters=5) -> float:
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


class Towers:
  """Counts vgg19.vgg_features calls by grad mode while it is active."""

  def __init__(self):
    self.calls = []

  def __enter__(self):
    self._original = vgg19.vgg_features

    def counted(image, model_filepath):
      self.calls.append('grad' if torch.is_grad_enabled() else 'no_grad')
      return self._original(image, model_filepath)

    vgg19.vgg_features = counted
    return self

  def __exit__(self, *exc):
    vgg19.vgg_features = self._original


def style_losses(mat_path):
  config = configs.get_experiment('film_net-Style', mat_path)
  return config, losses_lib.training_losses(
      list(config.training_losses.names),
      loss_weight_schedules=list(config.training_losses.weight_schedules),
      vgg_model_file=config.vgg_model_file)


def graph_rate(model, losses, batches, step0):
  """Steps/s of the captured lean step, its device ms, and its pool."""
  opts = train_lib.TrainingOptions()
  state = train_lib.create_train_state(model, opts)
  state.step = step0
  step_fn = train_lib.make_train_step(losses, opts, with_summaries=False)
  for i in range(WARMUP_STEPS):
    step_fn(state, batches[i % len(batches)], torch.Generator())
  torch.cuda.synchronize()
  start = time.perf_counter()
  for i in range(TIMED_STEPS):
    step_fn(state, batches[i % len(batches)], torch.Generator())
  torch.cuda.synchronize()
  rate = TIMED_STEPS / (time.perf_counter() - start)
  device_ms = events_ms(lambda: step_fn(state, batches[0],
                                        torch.Generator()), iters=10)
  program = step_fn.programs()[0]
  pool_bytes = program.pool_bytes
  program.release()
  return rate, device_ms, pool_bytes


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  card = card_line()
  print(card, flush=True)
  device = torch.device('cuda')
  report = {'card': card}
  rng = np.random.RandomState(1)
  batches = [train_lib.batch_to_device(square_batch(rng), device)
             for _ in range(4)]
  with tempfile.TemporaryDirectory() as work:
    mat_path = os.path.join(work, 'imagenet-vgg-verydeep-19.mat')
    write_vgg_mat(mat_path)
    config, style = style_losses(mat_path)
    model = init_params(create_model(config.model),
                        torch.Generator().manual_seed(0)).cuda()
    opts = train_lib.TrainingOptions()

    # The towers of one eager Style step, and its peak memory.
    state = train_lib.create_train_state(model, opts)
    state.step = STYLE_STEP
    eager_fn = train_lib.make_train_step(style, opts, with_summaries=False,
                                         graphs=False)
    eager_fn(state, batches[0], torch.Generator())  # Adam's state, plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Towers() as towers:
      eager_fn(state, batches[1], torch.Generator())
    torch.cuda.synchronize()
    report['step_towers'] = towers.calls
    report['eager_style_peak'] = torch.cuda.max_memory_allocated()
    del state, eager_fn

    rates = {}
    for label, losses, step0 in (('style', style, STYLE_STEP),
                                 ('l1', losses_lib.training_losses(['l1']),
                                  0)):
      rates[label] = graph_rate(model, losses, batches, step0)
      torch.cuda.empty_cache()
    report['graph'] = {k: {'steps_per_s': r, 'device_ms': ms,
                           'pool_bytes': pool}
                       for k, (r, ms, pool) in rates.items()}

    # The losses' forward and image backward.
    with torch.no_grad():
      image = model(batches[0]['x0'], batches[0]['x1'],
                    batches[0]['time'])['image']
    parts = {}
    for label, names in (('vgg', ['k*vgg']), ('style', ['k*style']),
                         ('vgg+style', ['k*vgg', 'k*style'])):
      subset = {name: style[name] for name in names}

      def run(subset=subset):
        pred = image.detach().requires_grad_()
        losses_lib.compute_weighted_loss(subset, batches[0], {'image': pred},
                                         STYLE_STEP).backward()

      parts[label] = events_ms(run)
    report['loss_ms'] = parts
    share = parts['vgg+style'] / rates['style'][1]

    # A Style eval batch: the training loss and the test losses.
    metrics = metrics_lib.create_metrics_fns(
        losses_lib.test_losses(['l1', 'vgg', 'style'],
                               vgg_model_file=mat_path), style)
    host = square_batch(np.random.RandomState(5))
    datasets = {'squares': [host] * EVAL_BATCHES}
    with Towers() as towers:
      eval_lib.eval_loop(model, {'squares': [host]}, metrics, STYLE_STEP,
                         log_fn=lambda _: None, graphs=False)
    report['eval_towers'] = towers.calls
    eval_ms = []
    for _ in range(EVAL_LOOPS):
      torch.cuda.synchronize()
      start = time.perf_counter()
      eval_lib.eval_loop(model, datasets, metrics, STYLE_STEP,
                         log_fn=lambda _: None)
      torch.cuda.synchronize()
      eval_ms.append(1e3 * (time.perf_counter() - start) / EVAL_BATCHES)
    report['eval_ms_per_batch'] = eval_ms

  gib = lambda n: n / 2**30
  g = report['graph']
  print(f'style_step: towers a Style step {report["step_towers"]}, a Style '
        f'eval batch {report["eval_towers"]}; graph steps/s Style '
        f'{g["style"]["steps_per_s"]:.3f} ({g["style"]["device_ms"]:.3f} ms '
        f'a step by CUDA events), L1 {g["l1"]["steps_per_s"]:.3f} '
        f'({g["l1"]["device_ms"]:.3f} ms); Style pool '
        f'{gib(g["style"]["pool_bytes"]):.3f} GiB, L1 pool '
        f'{gib(g["l1"]["pool_bytes"]):.3f} GiB, eager Style step peak '
        f'{gib(report["eager_style_peak"]):.3f} GiB; forward + image '
        f'backward ms: vgg {parts["vgg"]:.3f}, style {parts["style"]:.3f}, '
        f'vgg+style {parts["vgg+style"]:.3f} ({100 * share:.1f}% of the Style '
        f'step); Style eval ms a batch of {BATCH} (captured, {EVAL_BATCHES} '
        f'batches a loop) {[round(v, 3) for v in eval_ms]}; batch {BATCH}x'
        f'{CROP}x{CROP}, f32, TF32 allowed; on {card}', flush=True)
  report['share'] = share
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'style_step.json'), 'w') as f:
      json.dump(report, f, indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
