#!/usr/bin/env python3
"""The captured graphs' memory across keys (utils/programs.py's pools).

  python3 tools/graph_memory.py [--phases sizes,orders,reserve,tree,mixed]
                                [--out DIR]

Drives the Interpolator's pair program (released config, bf16 policy,
seed-0 weights) on the card and reports, for each capture, how much it
grew its pool (`Capture.pool_bytes`), with the pool's clears and the
device memory held:

  * sizes: each key alone in a fresh pool (1080p at batch 1-3, 720p at
    batch 1 and 3, 1440p and 4K at batch 1), beside its eager peak;
  * orders: 1080p at batch 1, 2, 3 captured into one pool in ascending
    and in descending order, with the budget lifted, and whether the
    pool's segments are expandable (PYTORCH_CUDA_ALLOC_CONF);
  * reserve: the ascending order into a pool that first holds one free
    block of the largest key's size, made with torch.cuda.MemPool;
  * tree: the 17-frame tree of 3 uint8 1080p frames at T = 3 after three
    1080p pair requests: the cached route twice, then the chunked route
    at max_batch 3 three times; ms a frame, captures, pool bytes and
    clears of each call;
  * mixed: chip_smoke.py's MIXED_KEYS in turn through one Interpolator;
    held memory, the pool's bytes, graphs and clears after each call.

It imports the port from the checkout it sits in and only entry points
that the port has had since its programs were captured, so a copy placed
in an unpacked older checkout's tools/ measures that checkout. Prints the
card and its power limit; `--out` keeps a JSON of every number. Needs a
GPU.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from frame_interpolation_tpu_torch.inference import Interpolator  # noqa: E402
from frame_interpolation_tpu_torch.inference import interpolator as interpolator_lib  # noqa: E402
from frame_interpolation_tpu_torch.models import create_model, init_params  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
from frame_interpolation_tpu_torch.utils import programs  # noqa: E402

GIB = 2**30
SIZE_KEYS = ((1080, 1920, 1), (1080, 1920, 2), (1080, 1920, 3),
             (720, 1280, 1), (720, 1280, 3), (1440, 2560, 1),
             (2160, 3840, 1))
ORDER_KEYS = ((1080, 1920, 1), (1080, 1920, 2), (1080, 1920, 3))
# chip_smoke.py's MIXED_KEYS.
MIXED_KEYS = ((1080, 1920, 1), (1080, 1920, 2), (1440, 2560, 1),
              (720, 1280, 1), (720, 1280, 3), (1080, 1920, 3),
              (2160, 3840, 1), (1080, 1920, 1), (720, 1280, 1))
TREE_FRAMES, TREE_TIMES, TREE_MAX_BATCH = 3, 3, 3
TREE_OUTPUTS = (TREE_FRAMES - 1) * 2**TREE_TIMES + 1


def card_line() -> str:
  if not torch.cuda.is_available():
    raise SystemExit('graph_memory: torch.cuda.is_available() is false; '
                     'this script needs a CUDA GPU')
  query = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return query.stdout.strip().splitlines()[0]


def gib(n: float) -> float:
  return round(n / GIB, 3)


def release() -> None:
  gc.collect()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()


def model_and_options():
  options = Options.film_net_released(dtype_policy='bfloat16')
  return init_params(create_model(options),
                     torch.Generator().manual_seed(0)), options


def pair_inputs(key, seed=0):
  height, width, batch = key
  rng = np.random.RandomState(seed)
  x0, x1 = (torch.from_numpy(rng.rand(batch, height, width, 3).astype(
      np.float32)).cuda() for _ in range(2))
  return x0, x1, torch.full((batch,), 0.5, device='cuda')


def pair_call(interpolator, key):
  """One pair call of `key`: the captures it made (their pool bytes), the
  pool's bytes and clears after it, and the memory reserved."""
  program = interpolator.programs['pair']
  before = list(program.captures.values())
  inputs = pair_inputs(key)
  start = time.perf_counter()
  interpolator.interpolate_device(*inputs)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  new = [c for c in program.captures.values()
         if not any(c is old for old in before)]
  return {'key': list(key), 'seconds': seconds,
          'captured_bytes': [c.pool_bytes for c in new],
          'pool_bytes': program.pool.bytes, 'clears': program.pool.clears,
          'graphs': len(program.captures),
          'reserved': torch.cuda.memory_reserved()}


def pool_segments() -> dict:
  """The private pools' segments: count, bytes, and how many are
  expandable."""
  count = total = expandable = 0
  for segment in torch.cuda.memory_snapshot():
    if tuple(segment.get('segment_pool_id', (0, 0))) == (0, 0):
      continue
    count += 1
    total += segment['total_size']
    expandable += bool(segment.get('is_expandable', False))
  return {'segments': count, 'bytes': total, 'expandable': expandable}


def phase_sizes(card):
  model, options = model_and_options()
  rows = []
  for key in SIZE_KEYS:
    release()
    eager = Interpolator(model, options, align=64, device='cuda',
                         graphs=False)
    inputs = pair_inputs(key)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager.interpolate_device(*inputs)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    del eager, inputs
    release()
    graphs = Interpolator(model, options, align=64, device='cuda')
    row = pair_call(graphs, key)
    row['eager_peak'] = eager_peak
    rows.append(row)
    print(f'graph_memory sizes: {key} alone: grew a fresh pool by '
          f'{gib(sum(row["captured_bytes"]))} GiB, eager peak '
          f'{gib(eager_peak)} GiB, first call {row["seconds"]:.2f} s; on '
          f'{card}', flush=True)
    graphs.release_graphs()
    del graphs
  return rows


def capture_in_order(model, options, keys, pool=None):
  """`keys` captured in turn into one pool with the budget lifted."""
  saved = programs.POOL_BUDGET_SHARE
  programs.POOL_BUDGET_SHARE = 10.0
  try:
    graphs = Interpolator(model, options, align=64, device='cuda',
                          **({'pool': pool} if pool is not None else {}))
  finally:
    programs.POOL_BUDGET_SHARE = saved
  rows = [pair_call(graphs, key) for key in keys]
  segments = pool_segments()
  # A second round: every key replays, nothing is captured.
  again = [pair_call(graphs, key) for key in keys]
  graphs.release_graphs()
  del graphs
  return rows, segments, again


def phase_orders(card):
  model, options = model_and_options()
  report = {'alloc_conf': os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')}
  for label, keys in (('ascending', ORDER_KEYS),
                      ('descending', ORDER_KEYS[::-1])):
    release()
    rows, segments, again = capture_in_order(model, options, keys)
    report[label] = {'calls': rows, 'segments': segments,
                     'recaptured': sum(len(r['captured_bytes'])
                                       for r in again)}
    print(f'graph_memory orders (PYTORCH_CUDA_ALLOC_CONF '
          f'{report["alloc_conf"] or "unset"}): {label} '
          f'{[tuple(k) for k in keys]}: each capture '
          f'grew the pool by {[gib(sum(r["captured_bytes"])) for r in rows]}'
          f' GiB, {gib(rows[-1]["pool_bytes"])} in all; private segments '
          f'{segments}; a second round recaptured '
          f'{report[label]["recaptured"]}; on {card}', flush=True)
  return report


def phase_reserve(card, sizes):
  """The ascending order into a pool that first holds one free block as
  large as the largest of ORDER_KEYS' lone graphs."""
  model, options = model_and_options()
  lone = {tuple(r['key']): sum(r['captured_bytes']) for r in sizes or []}
  need = max((lone.get(k, 0) for k in ORDER_KEYS), default=0) or 12 * GIB
  release()
  mempool = torch.cuda.MemPool()
  with torch.cuda.use_mem_pool(mempool):
    block = torch.empty(need, dtype=torch.uint8, device='cuda')
  del block
  pool = programs.Pool()
  pool.handle = mempool.id
  pool.done = torch.cuda.Event()
  rows, segments, again = capture_in_order(model, options, ORDER_KEYS, pool)
  report = {'reserved_block': need, 'calls': rows, 'segments': segments,
            'recaptured': sum(len(r['captured_bytes']) for r in again)}
  print(f'graph_memory reserve: one free block of {gib(need)} GiB, then '
        f'{list(ORDER_KEYS)} ascending: each capture grew the pool by '
        f'{[gib(sum(r["captured_bytes"])) for r in rows]} GiB; private '
        f'segments {segments}; a second round recaptured '
        f'{report["recaptured"]}; on {card}', flush=True)
  del pool, mempool
  return report


def phase_tree(card):
  model, options = model_and_options()
  release()
  interpolator = Interpolator(model, options, align=64, device='cuda')
  program = interpolator.programs['pair']
  calls = [pair_call(interpolator, (1080, 1920, 1)) for _ in range(3)]
  frames = torch.from_numpy(np.random.RandomState(0).randint(
      0, 256, (TREE_FRAMES, 1080, 1920, 3)).astype(np.uint8)).cuda()

  def cached():
    return interpolator.expand_tree_device(frames, TREE_TIMES)

  def chunked():
    with torch.inference_mode():
      return interpolator_lib.expand_tree_chunked(
          interpolator.to_device(frames), TREE_TIMES, TREE_MAX_BATCH, False,
          interpolator.interpolate_device)

  rows = []
  for label, tree in (('cached', cached), ('cached', cached),
                      ('chunked', chunked), ('chunked', chunked),
                      ('chunked', chunked)):
    before = {name: list(p.captures.values())
              for name, p in interpolator.programs.items()}
    clears = program.pool.clears
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = tree()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start)
    captured = {name: [gib(c.pool_bytes) for c in p.captures.values()
                       if not any(c is old for old in before[name])]
                for name, p in interpolator.programs.items()}
    rows.append({'route': label, 'ms_per_frame': ms / TREE_OUTPUTS,
                 'captured': {k: v for k, v in captured.items() if v},
                 'clears': program.pool.clears - clears,
                 'pool_bytes': program.pool.bytes,
                 'reserved': torch.cuda.memory_reserved(),
                 'shape': list(out.shape)})
    del out
  for r in rows:
    print(f'graph_memory tree: {r["route"]} ({TREE_FRAMES} uint8 1080p '
          f'frames, T = {TREE_TIMES}, {TREE_OUTPUTS} frames, max_batch '
          f'{TREE_MAX_BATCH}): {r["ms_per_frame"]:.3f} ms a frame on the '
          f'host clock (captures and all), captured {r["captured"]} GiB, '
          f'{r["clears"]} clears in the call, pool {gib(r["pool_bytes"])} '
          f'GiB, reserved {gib(r["reserved"])} GiB; on {card}', flush=True)
  report = {'pair_calls': calls, 'calls': rows,
            'live_graphs': {name: len(p.captures)
                            for name, p in interpolator.programs.items()},
            'clears': program.pool.clears}
  print(f'graph_memory tree: live graphs {report["live_graphs"]}, the pool '
        f'emptied {report["clears"]} times in all; on {card}', flush=True)
  interpolator.release_graphs()
  return report


def phase_mixed(card):
  model, options = model_and_options()
  release()
  base = torch.cuda.memory_reserved()
  interpolator = Interpolator(model, options, align=64, device='cuda')
  rows = []
  for key in MIXED_KEYS:
    row = pair_call(interpolator, key)
    row['held'] = row['reserved'] - base
    rows.append(row)
  held = max(r['held'] for r in rows)
  print(f'graph_memory mixed: {[tuple(k) for k in MIXED_KEYS]}: captured '
        f'{[[gib(b) for b in r["captured_bytes"]] for r in rows]} GiB, held '
        f'{[gib(r["held"]) for r in rows]} GiB, pool '
        f'{[gib(r["pool_bytes"]) for r in rows]}, graphs '
        f'{[r["graphs"] for r in rows]}, clears {rows[-1]["clears"]}; most '
        f'held {gib(held)} GiB; on {card}', flush=True)
  interpolator.release_graphs()
  return {'calls': rows, 'held': held, 'clears': rows[-1]['clears']}


def main() -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--phases', default='sizes,orders,reserve,tree,mixed')
  parser.add_argument('--out', default=None)
  args = parser.parse_args()
  card = card_line()
  print(card, flush=True)
  phases = args.phases.split(',')
  report = {'card': card}
  if 'sizes' in phases:
    report['sizes'] = phase_sizes(card)
  if 'orders' in phases:
    report['orders'] = phase_orders(card)
  if 'reserve' in phases:
    report['reserve'] = phase_reserve(card, report.get('sizes'))
  if 'tree' in phases:
    report['tree'] = phase_tree(card)
  if 'mixed' in phases:
    report['mixed'] = phase_mixed(card)
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'graph_memory.json'), 'w') as f:
      json.dump(report, f, indent=1, default=str)
  return 0


if __name__ == '__main__':
  sys.exit(main())
