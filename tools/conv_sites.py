#!/usr/bin/env python3
"""The conv kernel (csrc/conv3x3.cu) at every site of the main paths.

  python3 tools/conv_sites.py

Records the shapes that ops/conv_stack.conv3x3_leaky is called with by one
1080p pair through `Interpolator.call_device` (released config, bf16
policy) and by the forward of one film_net-L1 train step (released config,
f32, batch 8 of 256x256). Then, on fresh seeded inputs of each distinct
shape, it times `conv3x3_leaky_kernel` with CUDA events beside `F.conv2d`
with bias on channels-last tensors (cuDNN: the conv and bias only, without
the activation and the pool) and the bound: the larger of the FLOPs over
the dtype's peak and the bytes (each input read once, each output written
once) over HBM's rate. The timer and the bounds are chip_smoke.py's
(utils/measure.py). The train step's sites are timed twice: with TF32
allowed (PyTorch's default; the kernel's TF32 route) and with it off (the
exact f32 route). Prints the host's time per kernel call, one line per
distinct site and the totals per pair and per step, each naming the card
and its power limit. Needs a GPU.

It imports the port from the checkout it sits in, so a copy placed in
another checkout's tools/ (an unpacked parent commit, say), with a copy of
frame_interpolation_tpu_torch/utils/measure.py in that checkout's package,
times that checkout's kernel in the same call, with the same timer and
bounds.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import conv_stack  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.training import configs  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402

ITERS = 20
TRAIN_BATCH, TRAIN_CROP = 8, 256


def card_line() -> str:
  if not torch.cuda.is_available():
    raise SystemExit('conv_sites: torch.cuda.is_available() is false; this '
                     'script needs a CUDA GPU')
  return measure.card_line()


@contextlib.contextmanager
def recording(sites: collections.Counter):
  """Counts every conv3x3_leaky call while it runs, keyed by its site:
  (N, H, W, Cin, Cout, pool, dtype)."""
  original = conv_stack.conv3x3_leaky

  def record(x, weight, bias, pool=False, negative_slope=0.2):
    n, h, w, cin = x.shape
    sites[(n, h, w, cin, weight.shape[0], pool, x.dtype)] += 1
    return original(x, weight, bias, pool, negative_slope)

  conv_stack.conv3x3_leaky = record
  try:
    yield
  finally:
    conv_stack.conv3x3_leaky = original


def pair_sites() -> collections.Counter:
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  # Eager: a captured program's first call runs the forward twice (its
  # warm-up, then the capture), which would count each site twice.
  interpolator = Interpolator(model, options, align=64, device='cuda',
                              graphs=False)
  frames = torch.from_numpy(np.random.RandomState(0).rand(
      2, 1, 1080, 1920, 3).astype(np.float32)).cuda()
  sites = collections.Counter()
  with recording(sites):
    interpolator.call_device(frames[0], frames[1],
                             torch.full((1,), 0.5, device='cuda'))
  return sites


def train_sites() -> collections.Counter:
  options = configs.get_experiment('film_net-L1').model
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  rng = np.random.RandomState(1)
  x0, x1 = (torch.from_numpy(rng.rand(TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP,
                                      3).astype(np.float32)).cuda()
            for _ in range(2))
  sites = collections.Counter()
  with recording(sites), torch.no_grad():
    model(x0, x1, torch.full((TRAIN_BATCH, 1), 0.5, device='cuda'))
  return sites


def time_site(site: tuple, tf32: bool, rng) -> dict:
  n, h, w, cin, cout, pool, dtype = site
  x = torch.from_numpy((rng.rand(n, h, w, cin) * 2 - 1).astype(
      np.float32)).to('cuda', dtype)
  weight = torch.from_numpy((rng.randn(cout, cin, 3, 3) * (9.0 * cin)**-0.5
                             ).astype(np.float32)).cuda()
  bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda()
  nchw = x.permute(0, 3, 1, 2)
  w_cl = weight.to(dtype).contiguous(memory_format=torch.channels_last)
  b_lib = bias.to(dtype)
  saved = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    kernel_ms = measure.time_ms(
        lambda: conv_stack.conv3x3_leaky_kernel(x, weight, bias, pool), ITERS)
    library_ms = measure.time_ms(
        lambda: F.conv2d(nchw, w_cl, b_lib, padding=1), ITERS)
  finally:
    torch.backends.cudnn.allow_tf32 = saved
  kind = 'tf32' if tf32 and dtype == torch.float32 else str(dtype)[6:]
  bound = measure.roofline(
      *measure.conv_cost(n, h, w, cin, cout, pool, x.element_size()),
      measure.PEAK_FLOPS[kind])
  return {'kind': kind, 'ms': kernel_ms, 'library_ms': library_ms, **bound}


def report(label: str, unit: str, sites: collections.Counter, tf32: bool,
           card: str) -> None:
  rng = np.random.RandomState(0)
  totals = collections.Counter()
  for site, count in sorted(sites.items(), key=lambda s: -s[0][1] * s[0][2]):
    n, h, w, cin, cout, pool, _ = site
    r = time_site(site, tf32, rng)
    for key in ('ms', 'library_ms', 'bound_ms'):
      totals[key] += count * r[key]
    print(f'site {label} {n}x{h}x{w} {cin}->{cout}{"+pool" if pool else ""} '
          f'{r["kind"]} x{count}: kernel {r["ms"]:.4f} ms, library '
          f'{r["library_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
          f'({r["bound_by"]}), share {r["bound_ms"] / r["ms"]:.3f}')
  print(f'total {label}: {sum(sites.values())} sites, kernel '
        f'{totals["ms"]:.3f} ms/{unit}, library {totals["library_ms"]:.3f} '
        f'ms/{unit}, bound {totals["bound_ms"]:.3f} ms/{unit}, share '
        f'{totals["bound_ms"] / totals["ms"]:.3f} (CUDA events, mean of '
        f'{ITERS} per site; {card})')


# Device cycles (about 50 ms at 1.98 GHz) the card spins while the host
# issues the calls of the busy-device measurement.
BUSY_CYCLES = 100_000_000


def host_us_per_call(card: str, calls: int = 2000, busy_calls: int = 200
                     ) -> None:
  """Host time of one conv3x3_leaky_kernel call (wrapper checks, weight
  cache, tensor maps, launch) at the coarsest pair site: first on an idle
  device, which finishes each call long before the host issues the next;
  then with the device busy for about 50 ms, so that a call which waits
  for the device shows it."""
  x = torch.zeros(1, 17, 30, 512, device='cuda', dtype=torch.bfloat16)
  weight = torch.zeros(512, 512, 3, 3, device='cuda')
  bias = torch.zeros(512, device='cuda')
  for _ in range(3):
    conv_stack.conv3x3_leaky_kernel(x, weight, bias, False)
  torch.cuda.synchronize()
  us = {}
  for label, n, spin in (('idle', calls, 0), ('busy', busy_calls,
                                              BUSY_CYCLES)):
    if spin:
      torch.cuda._sleep(spin)
    start = time.perf_counter()
    for _ in range(n):
      conv_stack.conv3x3_leaky_kernel(x, weight, bias, False)
    us[label] = 1e6 * (time.perf_counter() - start) / n
    torch.cuda.synchronize()
  print(f'host: {us["idle"]:.2f} us per conv3x3_leaky_kernel call on an '
        f'idle device ({calls} calls), {us["busy"]:.2f} us with the device '
        f'busy for about 50 ms ({busy_calls} calls) (host clock, 1x17x30 '
        f'512->512 bf16; {card})')


def main() -> int:
  card = card_line()
  host_us_per_call(card)
  report('pair', 'pair', pair_sites(), False, card)
  sites = train_sites()
  report('train-tf32', 'step', sites, True, card)
  report('train-f32', 'step', sites, False, card)
  return 0


if __name__ == '__main__':
  sys.exit(main())
