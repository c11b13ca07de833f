#!/usr/bin/env python3
"""Device time of a 1080p midpoint by kernel and by the port's call site,
on one CUDA GPU.

  python3 tools/elementwise_sites.py [--batch 2] [--midpoints 3] [--top 25]

Runs the released film_net (seeded random weights, bf16 policy) on a
batch of uint8-valued 1088x1920 pairs through `FilmNet` under no_grad,
eagerly (no CUDA graph, so each kernel has the Python stack of the op
that launched it), as the video cell's chunks of 2 pairs run it, after
one warm-up. Under torch.profiler with stacks it attributes each device
kernel to the innermost frame of the stack that lies in
frame_interpolation_tpu_torch/ (file(line of its def): function), read
from the Chrome trace (a kernel's launch is the runtime call with its
correlation id; the op and the Python functions around that call on its
thread name it), and prints, in ms a midpoint:
  * device time by kernel name (the top `--top`);
  * device time of PyTorch's elementwise kernels (`elementwise_kernel`,
    `vectorized_elementwise_kernel`, and the other copies and casts)
    by call site, with the op that launched them;
  * device time by call site over all kernels.
The same lines go to stdout as JSON at the end. Each line names the card
and its power limit. Needs a GPU.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.ops import _kernels  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.utils import measure  # noqa: E402

PACKAGE = 'frame_interpolation_tpu_torch/'
# PyTorch's elementwise and copy kernels, the strided (non-vectorized)
# kernel first.
ELEMENTWISE = re.compile(r'elementwise_kernel|CatArray|copy|Copy')


def short(name: str) -> str:
  """A kernel's name without its namespace, template arguments and
  parameters."""
  name = name.replace('(anonymous namespace)', '')
  return re.split(r'[<(]', name)[0].split('::')[-1].split(' ')[-1] or name


def _innermost(intervals, starts, t):
  """The innermost of properly nested `intervals` (sorted by start, with
  their `starts`) that holds time t, or None."""
  i = bisect.bisect_right(starts, t) - 1
  while i >= 0:
    if intervals[i][1] >= t:
      return intervals[i]
    i -= 1
  return None


def attribute(events):
  """(kernel, launching op, site, us) for each device kernel of a Chrome
  trace: its launch is the runtime call with the same correlation id, the
  op the innermost CPU op around that call on its thread (none for a
  launch from Python, as the port's kernels are), the site the innermost
  Python function of the package around it."""
  launches = {}
  ops = collections.defaultdict(list)
  sites = collections.defaultdict(list)
  for e in events:
    cat = e.get('cat', '')
    if e.get('ph') != 'X':
      continue
    if cat in ('cuda_runtime', 'cuda_driver'):
      corr = e.get('args', {}).get('correlation')
      if corr is not None:
        launches[corr] = (e['ts'], e['tid'])
    elif cat == 'cpu_op':
      ops[e['tid']].append((e['ts'], e['ts'] + e['dur'], e['name']))
    elif cat == 'python_function' and PACKAGE in e['name']:
      name = e['name']
      sites[e['tid']].append((e['ts'], e['ts'] + e['dur'],
                              name[name.index(PACKAGE) + len(PACKAGE):]))
  starts = {}
  for table in (ops, sites):
    for intervals in table.values():
      intervals.sort()
      starts[id(intervals)] = [iv[0] for iv in intervals]

  def innermost(table, tid, t):
    intervals = table.get(tid, [])
    found = _innermost(intervals, starts.get(id(intervals), []), t)
    return None if found is None else found[2]

  out = []
  for e in events:
    if e.get('ph') != 'X' or e.get('cat') not in ('kernel', 'gpu_memcpy',
                                                  'gpu_memset'):
      continue
    op = site = None
    launch = launches.get(e.get('args', {}).get('correlation'))
    if launch is not None:
      t, tid = launch
      op, site = innermost(ops, tid, t), innermost(sites, tid, t)
    out.append((short(e['name']), op or '(launched from Python)',
                site or '(no frame of the package)', float(e['dur'])))
  return out


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--batch', type=int, default=2)
  parser.add_argument('--midpoints', type=int, default=3,
                      help='profiled forwards')
  parser.add_argument('--top', type=int, default=25)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('elementwise_sites: needs a CUDA GPU')
  card = measure.card_line()
  print(card, flush=True)
  _kernels.library()
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  rng = np.random.RandomState(0)
  frames = [torch.from_numpy(
      rng.randint(0, 256, (args.batch, 1088, 1920, 3)).astype(np.float32) /
      255.0).cuda() for _ in range(2)]
  time = torch.full((args.batch, 1), 0.5, device='cuda')

  @torch.no_grad()
  def forward():
    return model(frames[0], frames[1], time)['image']

  forward()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities, with_stack=True) as prof:
    for _ in range(args.midpoints):
      forward()
    torch.cuda.synchronize()
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)['traceEvents']
  per = 1e-3 / (args.midpoints * args.batch)  # us -> ms a midpoint
  by_kernel = collections.Counter()
  by_site = collections.Counter()
  elementwise = collections.Counter()
  total = 0.0
  for name, op, site, us in attribute(events):
    total += us
    by_kernel[name] += us
    by_site[site] += us
    if ELEMENTWISE.search(name):
      elementwise[(name, op, site)] += us
  if not total:
    raise SystemExit('elementwise_sites: the profiler saw no device kernels')
  print(f'device ms a midpoint: {total * per:.3f} (batch {args.batch}, '
        f'{args.midpoints} forwards; {card})')
  print('by kernel:')
  for name, us in by_kernel.most_common(args.top):
    print(f'  {us * per:8.3f}  {name}')
  print('elementwise kernels by call site (kernel, launching op, site):')
  for (name, op, site), us in elementwise.most_common(args.top):
    print(f'  {us * per:8.3f}  {name:32s} {op:28s} {site}')
  print('all kernels by call site:')
  for site, us in by_site.most_common(args.top):
    print(f'  {us * per:8.3f}  {site}')
  print(json.dumps({
      'card': card, 'batch': args.batch, 'ms_a_midpoint': total * per,
      'by_kernel': {k: v * per for k, v in by_kernel.most_common()},
      'elementwise': [[k, op, s, v * per]
                      for (k, op, s), v in elementwise.most_common()],
      'by_site': {k: v * per for k, v in by_site.most_common()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
