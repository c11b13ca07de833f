"""Pair requests: `Interpolator.__call__` on uint8 frames, numpy in and
out, offered at a fixed rate.

Traffic (the workload's `traffic`): `pool` pairs of `height` x `width`
uint8 frames made at set-up from the seed (traffic/frames.py, motions up
to `max_motion_px`), sent in turn at `rate_per_s`, evenly spaced, each
request timed by the host's clock from when it was due to when its numpy
result is back, so a late start counts. A
request due before the window's end is sent; every request sent counts.

Correct: once the window has closed, the first and the last answer of
`check_pairs` pairs of the pool drawn from the seed are held against the
plain reference (reference/film_net.py, float32, TF32 off) on the same
frames: the worst relative RMS gap of a frame, and the worst pixel's gap.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import weights
from ..reference import film_net as ref
from ..reference import lowp
from ..traffic import frames as traffic
from . import common


def gaps(answer: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
  """The relative RMS gap and the largest gap of one (H, W, 3) frame."""
  diff = answer.astype(np.float64) - reference
  return {'rel_rms': float(np.sqrt((diff**2).mean() / (reference**2).mean())),
          'max_abs': float(np.abs(diff).max())}


class Driver:

  def __init__(self, ctx):
    self.ctx = ctx
    self.traffic = ctx.workload['traffic']
    self.options = common.options_dict(ctx.config)
    self.align = int(ctx.config.get('align', 64))
    self.kept: Dict[int, List[np.ndarray]] = {}

  def setup(self) -> None:
    ctx, t = self.ctx, self.traffic
    self.interpolator = common.interpolator(ctx)
    self.pool = traffic.pairs(ctx.seed, int(t['pool']), int(t['height']),
                              int(t['width']), float(t['max_motion_px']),
                              ctx.device)
    self.dt = np.full((1,), 0.5, np.float32)
    self.checked = traffic.sample(ctx.seed, 'pair', len(self.pool),
                                  int(t['check_pairs']))
    # The first and the latest answer of each checked pair: at 1080p one
    # block of 190 MiB, which glibc maps apart from its heap, touched now.
    self.answers = np.empty((len(self.checked), 2, int(t['height']),
                             int(t['width']), 3), np.float32)
    self.answers.fill(0)
    # Every shape of the window: the pair program's warm-up and capture,
    # then a replay.
    for i in range(2):
      self.interpolator(self.pool[i][:1], self.pool[i][1:], self.dt)
    common.sync(ctx.device)

  def window(self) -> dict:
    ctx, t = self.ctx, self.traffic
    rate = float(t['rate_per_s'])
    due = np.arange(int(rate * ctx.seconds) + 1) / rate
    due = due[due < ctx.seconds]
    start = ctx.open_window()
    latencies, traced, failed = [], [], 0
    for i, offset in enumerate(due):
      wait = start + offset - time.perf_counter()
      if wait > 0:
        time.sleep(wait)
      pair = self.pool[i % len(self.pool)]
      traced.append(ctx.tracing)
      try:
        with ctx.span('request'):
          out = self.interpolator(pair[:1], pair[1:], self.dt)
      except RuntimeError:
        failed += 1
        traced.pop()
        continue
      latencies.append(time.perf_counter() - (start + offset))
      index = i % len(self.pool)
      if index in self.checked:
        slot = self.answers[self.checked.index(index)]
        if index not in self.kept:
          slot[0] = out[0]
        slot[1] = out[0]
        self.kept[index] = [slot[0], slot[1]]
      del out
      ctx.tick(1)
    ms = np.asarray(latencies) * 1e3
    return {'attempted': len(due), 'failed': failed,
            'latencies_ms': ms.tolist(),
            'untraced_ms': ms[~np.asarray(traced, bool)].tolist(),
            'metrics': {'pair_ms_p95': float(np.percentile(ms, 95))},
            'flops_per_unit': common.pair_flops(self.options, t,
                                                self.align)}

  def release(self) -> None:
    self.interpolator.release_graphs()
    del self.interpolator

  def check(self, quant=None) -> list:
    """[(name, worst reading, limit)]; `quant` puts the reference in the
    program's place (the control)."""
    ctx = self.ctx
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = weights.film_net(ref.parameter_shapes(self.options), ctx.seed,
                              ctx.device)
    worst = {'rel_rms': 0.0, 'max_abs': 0.0}
    with torch.no_grad():
      for index in self.checked:
        x0, x1 = (common.unit_nchw(self.pool[index][k:k + 1], ctx.device)
                  for k in (0, 1))
        want = ref.interpolate(params, self.options, x0, x1, self.align)
        want = want[0].permute(1, 2, 0).double().cpu().numpy()
        answers = self.kept.get(index, [])
        if quant is not None:
          answers = [ref.interpolate(params, self.options, x0, x1, self.align,
                                     lowp.QUANT[quant])[0].permute(
                                         1, 2, 0).cpu().numpy()]
        if not answers:
          worst = {k: float('inf') for k in worst}
        for answer in answers:
          for k, v in gaps(answer, want).items():
            worst[k] = max(worst[k], v)
    self.readings = worst
    return [(k, worst[k], float(v))
            for k, v in self.ctx.workload['limits'].items()]
