#!/usr/bin/env python3
"""Train steps and the splat in PyTorch's default and deterministic modes.

  python3 tools/step_modes.py [--out DIR]

Released config, f32, batch 8 of 256x256 moving squares, PyTorch's
default precision (cuDNN may use TF32). In each mode, the default one,
under torch.use_deterministic_algorithms(True) (CUBLAS_WORKSPACE_CONFIG
set first, as chip_smoke.py sets it) and, for the steps, with
torch.backends.cudnn.deterministic alone, reports:

  * lean train steps/s as CUDA graphs, film_net-L1 and film_net-Style
    (tools/style_step.graph_rate: the mean of 20 steps after 3, host
    clock), each step's device ms by CUDA events and its graph's pool
    bytes; the splat's device ms in an L1 step and the step's busy ms
    (torch.profiler over 5 replays, kernels named splat_*);
  * the bytes of the f32 accumulators the splats of one L1 step write
    (an eager step);
  * the splat (ops/warp.splat_kernel) at the four shapes PERF.md times
    it at, with chip_smoke.py's flows: its ms in each mode, whether two
    launches are bit-equal in the default mode, and in the default mode
    the image gradient of aten::grid_sampler_2d_backward (its library
    call, which raises under the deterministic mode) and the bound.

It imports the port, chip_smoke.py and tools/style_step.py from the
checkout it sits in, and only what they have had since tools/style_step.py
came in, so a copy placed in an unpacked older checkout's tools/
measures that checkout in the same call. Prints the card and its power limit; `--out`
keeps a JSON of every number. Needs a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
from pathlib import Path

# cuBLAS reads its workspace setting when its first handle is made.
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

import numpy as np  # noqa: E402
import torch  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / 'tools'))

import chip_smoke  # noqa: E402
import style_step  # noqa: E402
from frame_interpolation_tpu_torch import losses as losses_lib  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import warp  # noqa: E402
from frame_interpolation_tpu_torch.training import train_lib  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402

MODES = ('default', 'deterministic')
STEP_MODES = MODES + ('cudnn_deterministic',)
# (B, H, W, C, dtype, flow): PERF.md's four timed splat shapes.
SPLAT_SHAPES = ((8, 256, 256, 67, torch.float32, 'seam'),
                (8, 256, 256, 67, torch.float32, 'oob'),
                (8, 128, 128, 195, torch.float32, 'seam'),
                (1, 1088, 1920, 67, torch.bfloat16, 'seam'))
PROFILE_STEPS = 5


@contextlib.contextmanager
def mode(name: str):
  """The mode's switches while the block runs. The deterministic mode's
  NaN fill of new tensors stays on, as a user running it has it."""
  saved = torch.are_deterministic_algorithms_enabled()
  torch.use_deterministic_algorithms(name == 'deterministic')
  try:
    with torch.backends.cudnn.flags(
        enabled=True, benchmark=False,
        deterministic=name == 'cudnn_deterministic', allow_tf32=True):
      yield
  finally:
    torch.use_deterministic_algorithms(saved)


def splat_shape(b, h, w, c, dtype, flow_kind) -> dict:
  rng = np.random.RandomState(b * h + c)
  g = torch.from_numpy((rng.rand(b, h, w, c) - 0.5).astype(np.float32)).to(
      'cuda', dtype)
  flow = chip_smoke.training_flow(flow_kind, b, h, w)
  first, second = warp.splat_kernel(g, flow), warp.splat_kernel(g, flow)
  result = {'shape': f'{b}x{h}x{w}x{c} {str(dtype).split(".")[-1]}',
            'flow': flow_kind,
            'repeat_bit_equal': bool(torch.equal(first, second))}
  grid = measure.bilinear_grid(flow)
  g_nchw = g.float().permute(0, 3, 1, 2)
  image_nchw = torch.zeros_like(g_nchw)
  result['library_ms'] = measure.time_ms(
      lambda: torch.ops.aten.grid_sampler_2d_backward(
          g_nchw, image_nchw, grid, 0, 1, True, [True, False]))
  result.update(measure.roofline(
      8.0 * g.numel(), g.numel() * (g.element_size() + 4) + flow.numel() * 4,
      measure.PEAK_FLOPS['float32']))
  # In turns within the call: default, deterministic, twice. The
  # deterministic mode's NaN fill is off here: the kernel's time alone.
  fill = torch.utils.deterministic.fill_uninitialized_memory
  torch.utils.deterministic.fill_uninitialized_memory = False
  try:
    times = {m: [] for m in MODES}
    for name in MODES + MODES[::-1]:
      with mode(name):
        times[name].append(measure.time_ms(lambda: warp.splat_kernel(g,
                                                                     flow)))
  finally:
    torch.utils.deterministic.fill_uninitialized_memory = fill
  result['ms'] = times
  return result


def splat_in_step(model, losses, batches) -> dict:
  """The L1 graph step's busy ms and its splat kernels' ms, by profile."""
  opts = train_lib.TrainingOptions()
  state = train_lib.create_train_state(model, opts)
  step_fn = train_lib.make_train_step(losses, opts, with_summaries=False)
  profile = measure.idle_share(
      lambda: step_fn(state, batches[0], torch.Generator()), PROFILE_STEPS,
      named=('splat_',))
  step_fn.programs()[0].release()
  return {'busy_ms': profile['busy_ms'],
          'splat_ms': profile['named']['splat_']}


def splat_accumulator_bytes(model, losses, batches) -> int:
  """The f32 accumulators' bytes of the splats of one eager L1 step (what
  an accumulator that must start at 0 costs in zero-fill)."""
  sizes = []
  kernel = warp.splat_kernel

  def counted(g, flow):
    sizes.append(4 * g.numel())
    return kernel(g, flow)

  opts = train_lib.TrainingOptions()
  state = train_lib.create_train_state(model, opts)
  step_fn = train_lib.make_train_step(losses, opts, with_summaries=False,
                                      graphs=False)
  warp.splat_kernel = counted
  try:
    step_fn(state, batches[0], torch.Generator())
  finally:
    warp.splat_kernel = kernel
  return sum(sizes)


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  card = style_step.card_line()
  print(card, flush=True)
  device = torch.device('cuda')
  report = {'card': card, 'root': str(_ROOT), 'splat': [], 'steps': {}}
  for shape in SPLAT_SHAPES:
    r = splat_shape(*shape)
    report['splat'].append(r)
    print(f'step_modes: splat {r["shape"]} {r["flow"]} flow: ms default '
          f'{r["ms"]["default"]}, deterministic {r["ms"]["deterministic"]};'
          f' two default launches bit-equal {r["repeat_bit_equal"]}; '
          f'grid_sampler_2d_backward {r["library_ms"]:.3f} ms; bound '
          f'{r["bound_ms"]:.3f} ms ({r["bound_by"]})', flush=True)
  rng = np.random.RandomState(1)
  batches = [train_lib.batch_to_device(style_step.square_batch(rng), device)
             for _ in range(4)]
  with tempfile.TemporaryDirectory() as work:
    mat_path = os.path.join(work, 'imagenet-vgg-verydeep-19.mat')
    style_step.write_vgg_mat(mat_path)
    config, style = style_step.style_losses(mat_path)
    l1 = losses_lib.training_losses(['l1'])
    model = init_params(create_model(config.model),
                        torch.Generator().manual_seed(0)).cuda()
    for name in STEP_MODES:
      with mode(name):
        steps = {}
        for label, losses, step0 in (('l1', l1, 0),
                                     ('style', style, style_step.STYLE_STEP)):
          rate, device_ms, pool = style_step.graph_rate(model, losses,
                                                        batches, step0)
          steps[label] = {'steps_per_s': rate, 'device_ms': device_ms,
                          'pool_gib': pool / 2**30}
          torch.cuda.empty_cache()
        steps['l1'].update(splat_in_step(model, l1, batches))
        torch.cuda.empty_cache()
      report['steps'][name] = steps
      print(f'step_modes: {name} mode: L1 graph '
            f'{steps["l1"]["steps_per_s"]:.3f} steps/s '
            f'({steps["l1"]["device_ms"]:.3f} ms a step by CUDA events, '
            f'pool {steps["l1"]["pool_gib"]:.3f} GiB; splat '
            f'{steps["l1"]["splat_ms"]:.3f} of {steps["l1"]["busy_ms"]:.3f} '
            f'ms busy), Style graph {steps["style"]["steps_per_s"]:.3f} '
            f'steps/s ({steps["style"]["device_ms"]:.3f} ms, pool '
            f'{steps["style"]["pool_gib"]:.3f} GiB); batch '
            f'{style_step.BATCH}x{style_step.CROP}x{style_step.CROP}, f32, '
            f'TF32 allowed; on {card}', flush=True)
    # Last: the eager step updates the model.
    report['splat_accumulator_bytes'] = splat_accumulator_bytes(
        model, l1, batches)
  print(f'step_modes: the splats of one L1 step write '
        f'{report["splat_accumulator_bytes"] / 2**30:.3f} GiB of f32 '
        f'accumulators', flush=True)
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'step_modes.json'), 'w') as f:
      json.dump(report, f, indent=1)
  return 0


if __name__ == '__main__':
  sys.exit(main())
