#!/usr/bin/env python3
"""The split-concat convs against the concat form, on one CUDA GPU.

  python3 tools/split_convs.py [--repeats 3] [--pairs 5] [--steps 10]

Builds two models of the released config from the same seeded weights,
one with `Options.split_convs='on'` and one with 'off', and measures in
turns (off, on, on, off, `--repeats` times):
  * the 1080p pair under the bf16 policy (the (1, 1080, 1920, 3) pair
    from numpy seed 0, padded to 1088x1920): ms per pair, the mean of
    `--pairs` calls of `Interpolator.call_device` between CUDA events
    (the host's lag between launches counts);
  * the film_net-L1 train step (f32, batch 8 of 256x256 random triplets,
    train_lib's lean step without augmentation, PyTorch's default TF32
    for convs): steps/s by the host clock over `--steps` steps after 3.
Then, for each form, device time by kernel group per pair and per step
from a torch.profiler trace of three (tools/profile_pair.py's groups:
`torch.cat` copies, cuDNN's convs, the adds that carry the convs' bias
and the split form's partial sums), and our kernels' launches per pair.
The last line is a JSON object of every number. Each line names the card
and its power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from frame_interpolation_tpu_torch import losses  # noqa: E402
from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import _kernels  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.training import configs, train_lib  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402
from profile_pair import card_line, profile  # noqa: E402

FORMS = ('off', 'on')
WARMUP_STEPS = 3


def pair_fn(form: str, state):
  options = Options.film_net_released(dtype_policy='bfloat16',
                                      split_convs=form)
  model = create_model(options)
  model.load_state_dict(state)
  interpolator = Interpolator(model, options, align=64, device='cuda')
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  x0 = torch.from_numpy(frames[0]).cuda()
  x1 = torch.from_numpy(frames[1]).cuda()
  dt = torch.full((1,), 0.5, device='cuda')
  return lambda: interpolator.call_device(x0, x1, dt)


def step_fn(form: str, state):
  config = configs.get_experiment('film_net-L1')
  options = dataclasses.replace(config.model, split_convs=form)
  model = create_model(options)
  model.load_state_dict(state)
  model.cuda()
  opts = train_lib.TrainingOptions()
  step = train_lib.make_train_step(losses.training_losses(['l1']), opts,
                                   with_summaries=False)
  train_state = train_lib.create_train_state(model, opts)
  rng = np.random.RandomState(1)
  batch = train_lib.batch_to_device(
      {k: rng.rand(8, 256, 256, 3).astype(np.float32)
       for k in ('x0', 'x1', 'y')} | {'time': np.full((8, 1), 0.5)},
      torch.device('cuda'))
  return lambda: step(train_state, batch, torch.Generator())


def steps_per_s(fn, steps: int) -> float:
  for _ in range(WARMUP_STEPS):
    fn()
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(steps):
    fn()
  torch.cuda.synchronize()
  return steps / (time.perf_counter() - start)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--repeats', type=int, default=3)
  parser.add_argument('--pairs', type=int, default=5)
  parser.add_argument('--steps', type=int, default=10)
  args = parser.parse_args()
  card = card_line()
  torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
  _kernels.library()
  order = [f for _ in range(args.repeats) for f in ('off', 'on', 'on', 'off')]
  result = {'card': card}

  state = init_params(create_model(Options.film_net_released()),
                      torch.Generator().manual_seed(0)).state_dict()
  pairs = {form: pair_fn(form, state) for form in FORMS}
  launches = {}
  for form, fn in pairs.items():
    fn()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches[form] = _kernels.launch_counts()
  pair_ms = {form: [] for form in FORMS}
  for form in order:
    pair_ms[form].append(measure.time_ms(pairs[form], args.pairs,
                                         queued=False))
  for form in FORMS:
    times = pair_ms[form]
    print(f'pair split_convs={form}: {statistics.mean(times):.3f} ms/pair '
          f'(runs {[round(t, 3) for t in times]}, each the mean of '
          f'{args.pairs} by CUDA events); our launches {launches[form]}; '
          f'{card}')
  out_dir = Path(tempfile.mkdtemp())
  for form in FORMS:
    profile(pairs[form], 3, 'pair', card, out_dir, f'pair_{form}')
  result.update(pair_ms=pair_ms, launches=launches)
  del pairs

  train_state = init_params(
      create_model(configs.get_experiment('film_net-L1').model),
      torch.Generator().manual_seed(0)).state_dict()
  steps = {form: step_fn(form, train_state) for form in FORMS}
  rates = {form: [] for form in FORMS}
  for form in order:
    rates[form].append(steps_per_s(steps[form], args.steps))
  for form in FORMS:
    print(f'train step split_convs={form}: '
          f'{statistics.mean(rates[form]):.3f} steps/s (runs '
          f'{[round(r, 3) for r in rates[form]]}, each {args.steps} steps '
          f'after {WARMUP_STEPS}, host clock; batch 8x256x256 f32, TF32 '
          f'allowed); {card}')
  for form in FORMS:
    profile(steps[form], 3, 'step', card, out_dir, f'train_{form}')
  result['steps_per_s'] = rates
  faster_pair = min(FORMS, key=lambda f: statistics.mean(pair_ms[f]))
  faster_step = max(FORMS, key=lambda f: statistics.mean(rates[f]))
  print(f'faster form: pair split_convs={faster_pair}, train step '
        f'split_convs={faster_step}; {card}')
  shutil.rmtree(out_dir)
  print(json.dumps(result))
  return 0


if __name__ == '__main__':
  sys.exit(main())
