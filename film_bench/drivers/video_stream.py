"""Slow motion: `recursion.interpolate_frontier_streaming(frames, times,
interpolator, as_uint8=True)` over a clip, clips back to back, every
frame taken on the host as `cli/interpolate_dir.py` takes it.

Traffic: one clip of `frames` uint8 frames of `height` x `width` made at
set-up from the seed (traffic/frames.py, every layer moving by up to
`max_motion_px` a frame), expanded `times` deep ((frames - 1) * 2^times
+ 1 frames out, of which (frames - 1) * (2^times - 1) new). The window
counts the new frames handed over before it closes.

Correct: once the window has closed, `check_frames` new frames drawn from
the seed, as the first and the last whole clip of the window gave them,
and every input frame's place in the output, are held against the plain
reference (reference/film_net.py, float32, TF32 off), which makes each
drawn frame's recursion from the clip's frames itself (the midpoint of
the two frames around it, then down to it), quantized by the writers'
rule: the worst pixel's gap in levels, and the number of input frames not
in their place unchanged (the worst mean gap of a frame is read too, and
not compared: bf16 and the control's fp8 read too close on it).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import weights
from ..costs import film_net as costs
from ..reference import film_net as ref
from ..reference import lowp
from ..traffic import frames as traffic
from . import common


def lineage(position: int, times: int) -> List[Tuple[int, int, int]]:
  """(left, right, middle) positions, within one input pair's block of
  2^times + 1, of the midpoints that make the frame at `position`, the
  first made first."""
  lo, hi, out = 0, 2**times, []
  while True:
    mid = (lo + hi) // 2
    out.append((lo, hi, mid))
    if mid == position:
      return out
    lo, hi = (lo, mid) if position < mid else (mid, hi)


class Driver:

  def __init__(self, ctx):
    self.ctx = ctx
    self.traffic = ctx.workload['traffic']
    self.options = common.options_dict(ctx.config)
    self.align = int(ctx.config.get('align', 64))
    self.times = int(self.traffic['times'])
    self.kept: Dict[int, List[np.ndarray]] = {}
    self.inputs_misplaced = 0

  def _stream(self, clip):
    from frame_interpolation_tpu_torch.inference import recursion
    return recursion.interpolate_frontier_streaming(
        clip, self.times, self.interpolator, as_uint8=True)

  def setup(self) -> None:
    ctx, t = self.ctx, self.traffic
    self.interpolator = common.interpolator(ctx)
    self.clip = traffic.clip(ctx.seed, int(t['frames']), int(t['height']),
                             int(t['width']), float(t['max_motion_px']),
                             ctx.device)
    per_pair = 2**self.times
    self.out_len = (len(self.clip) - 1) * per_pair + 1
    new = [p for p in range(self.out_len) if p % per_pair]
    self.checked = [new[i] for i in traffic.sample(
        ctx.seed, 'video', len(new), int(t['check_frames']))]
    # Every program and pinned buffer of the window: the features and the
    # pair's tree captured, the fetch pipeline filled.
    for _ in self._stream(self.clip[:int(t['warmup_frames'])]):
      pass
    common.sync(ctx.device)

  def window(self) -> dict:
    ctx = self.ctx
    per_pair = 2**self.times
    start = ctx.open_window()
    deadline = start + ctx.seconds
    new_frames, done = 0, False
    while not done:
      stream = self._stream(self.clip)
      with ctx.span('clip'):
        for position, frame in enumerate(stream):
          now = time.perf_counter()
          if now >= deadline:
            done = True
            break
          if position % per_pair:
            new_frames += 1
            if position in self.checked:
              kept = self.kept.setdefault(position, [])
              kept[1:] = [frame.copy()]
          elif not np.array_equal(frame, self.clip[position // per_pair]):
            self.inputs_misplaced += 1
          ctx.tick(1 if position % per_pair else 0)
      stream.close()
    seconds = time.perf_counter() - start
    common.sync(ctx.device)
    return {'attempted': new_frames, 'failed': 0,
            'metrics': {'video_frames_per_s': new_frames / seconds},
            'flops_per_unit': costs.tree_flops_per_new_frame(
                self.options, common.padded(int(self.traffic['height']),
                                            self.align),
                common.padded(int(self.traffic['width']), self.align),
                len(self.clip), self.times)}

  def release(self) -> None:
    self.interpolator.release_graphs()
    del self.interpolator

  def reference_frames(self, quant=None) -> Dict[int, np.ndarray]:
    """The drawn positions' frames by the plain recursion, uint8."""
    ctx = self.ctx
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = weights.film_net(ref.parameter_shapes(self.options), ctx.seed,
                              ctx.device)
    q = lowp.QUANT[quant] if quant else None
    per_pair = 2**self.times
    out = {}
    with torch.no_grad():
      for position in self.checked:
        pair = position // per_pair
        block = {0: common.unit_nchw(self.clip[pair][None], ctx.device),
                 per_pair: common.unit_nchw(self.clip[pair + 1][None],
                                            ctx.device)}
        for lo, hi, mid in lineage(position % per_pair, self.times):
          if mid not in block:
            block[mid] = ref.interpolate(params, self.options, block[lo],
                                         block[hi], self.align, q)
        frame = block[position % per_pair][0].permute(1, 2, 0)
        out[position] = traffic.to_uint8(frame).cpu().numpy()
    return out

  def check(self, quant=None) -> list:
    """[(name, worst reading, limit)]. With `quant`, the reference at that
    precision stands in the program's place (the control)."""
    want = self.reference_frames()
    got = ({p: [f] for p, f in self.reference_frames(quant).items()}
           if quant else self.kept)
    worst = {'mean_level_gap': 0.0, 'max_level_gap': 0.0,
             'inputs_misplaced': float(self.inputs_misplaced)}
    for position, expected in want.items():
      answers = got.get(position, [])
      if not answers:
        worst['mean_level_gap'] = worst['max_level_gap'] = float('inf')
      for answer in answers:
        diff = np.abs(answer.astype(np.int16) - expected.astype(np.int16))
        worst['mean_level_gap'] = max(worst['mean_level_gap'],
                                      float(diff.mean()))
        worst['max_level_gap'] = max(worst['max_level_gap'],
                                     float(diff.max()))
    self.readings = worst
    return [(k, worst[k], float(v))
            for k, v in self.ctx.workload['limits'].items()]
