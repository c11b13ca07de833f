"""Seeded scenes: a smooth textured background and textured discs, each
layer moving with a motion of its own.

One scene is a background and `objects` foreground layers. Every layer is
a texture (a sum of octaves of bilinearly upsampled uniform noise, so it
is smooth with detail at 4 to 64 pixels) and every foreground layer also
a mask of a few discs. A layer at time t is its texture (and mask) shifted
by t times its velocity, sampled bilinearly; the frame composites the
layers back to front. Velocities are drawn in pixels per unit of time
from [-max_motion, max_motion] per axis: a pair spans t = 0 to 1, a
triplet's middle frame is t = 0.5, a clip's frame k is t = k.

All draws come from generators seeded by (seed, what, index), on the
device given, in a few large calls; the same seed gives the same frames.
Sizes and counts are the caller's, from the traffic file: every seed gets
the same work.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

OCTAVES = ((64, 0.45), (16, 0.35), (4, 0.2))


def derived_seed(seed: int, *what) -> int:
  """A 63-bit seed for one purpose, from the run's seed (any size)."""
  text = repr((int(seed),) + tuple(what)).encode()
  return int.from_bytes(hashlib.sha256(text).digest()[:8], 'little') >> 1


def _generator(seed: int, device, *what) -> torch.Generator:
  generator = torch.Generator(device=device)
  generator.manual_seed(derived_seed(seed, *what))
  return generator


def _texture(g, n, h, w, device) -> torch.Tensor:
  """(n, 3, h, w) smooth noise in [0, 1]."""
  out = torch.zeros(n, 3, h, w, device=device)
  for scale, amp in OCTAVES:
    base = torch.rand(n, 3, h // scale + 2, w // scale + 2, generator=g,
                      device=device)
    out += amp * F.interpolate(base, size=(h, w), mode='bilinear',
                               align_corners=False)
  return out


def _discs(g, n, h, w, count, device) -> torch.Tensor:
  """(n, 1, h, w) masks of `count` discs, soft by one pixel."""
  ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
  xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
  params = torch.rand(n, count, 3, generator=g, device=device)
  mask = torch.zeros(n, 1, h, w, device=device)
  for i in range(count):
    cy = params[:, i, 0, None, None] * h
    cx = params[:, i, 1, None, None] * w
    r = (0.04 + 0.12 * params[:, i, 2, None, None]) * min(h, w)
    d = torch.sqrt((ys - cy)**2 + (xs - cx)**2)
    mask = torch.maximum(mask, (r - d).clamp(0, 1)[:, None])
  return mask


def _shift(layer: torch.Tensor, dx: torch.Tensor,
           dy: torch.Tensor) -> torch.Tensor:
  """`layer` (n, c, h, w) moved by (dx, dy) pixels per example, bilinear,
  the edge repeated outside."""
  n, _, h, w = layer.shape
  ys = torch.arange(h, device=layer.device, dtype=torch.float32)[None, :, None]
  xs = torch.arange(w, device=layer.device, dtype=torch.float32)[None, None, :]
  qx = (xs - dx[:, None, None]) * (2.0 / (w - 1)) - 1
  qy = (ys - dy[:, None, None]) * (2.0 / (h - 1)) - 1
  grid = torch.stack([qx.expand(n, h, w), qy.expand(n, h, w)], -1)
  return F.grid_sample(layer, grid, mode='bilinear', padding_mode='border',
                       align_corners=True)


class Scenes:
  """`n` scenes of h x w with `objects` moving layers each."""

  def __init__(self, seed: int, what: str, n: int, h: int, w: int,
               max_motion: float, objects: int = 3, discs: int = 3,
               device='cpu'):
    g = _generator(seed, device, what)
    self.layers = [_texture(g, n, h, w, device)
                   for _ in range(objects + 1)]
    self.masks = [_discs(g, n, h, w, discs, device) for _ in range(objects)]
    self.velocity = (torch.rand(objects + 1, n, 2, generator=g,
                                device=device) * 2 - 1) * max_motion

  def frames(self, t: float) -> torch.Tensor:
    """(n, h, w, 3) float32 in [0, 1] at time t."""
    v = self.velocity * t
    frame = _shift(self.layers[0], v[0, :, 0], v[0, :, 1])
    for i, (layer, mask) in enumerate(zip(self.layers[1:], self.masks)):
      moved = _shift(torch.cat([layer, mask], 1), v[i + 1, :, 0],
                     v[i + 1, :, 1])
      alpha = moved[:, 3:]
      frame = moved[:, :3] * alpha + frame * (1 - alpha)
    return frame.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
  """The writers' rule: (clip(x * 255, 0, 255) + 0.5) truncated."""
  return (torch.clamp(x.float() * 255.0, 0.0, 255.0) + 0.5).to(torch.uint8)


def pairs(seed: int, count: int, h: int, w: int, max_motion: float,
          device) -> List[np.ndarray]:
  """`count` uint8 pairs, each (2, h, w, 3): frames at t = 0 and 1."""
  out = []
  for i in range(count):
    scenes = Scenes(seed, ('pair', i), 1, h, w, max_motion, device=device)
    both = torch.cat([scenes.frames(0.0), scenes.frames(1.0)])
    out.append(to_uint8(both).cpu().numpy())
  return out


def triplet_batches(seed: int, count: int, batch: int, size: int,
                    max_motion: float, device) -> List[Dict[str, np.ndarray]]:
  """`count` host batches of float32 triplets (x0, y, x1 at t = 0, 0.5,
  1), each (batch, size, size, 3), with 'time' (batch, 1) = 0.5."""
  out = []
  for i in range(count):
    scenes = Scenes(seed, ('triplets', i), batch, size, size, max_motion,
                    device=device)
    out.append({'x0': scenes.frames(0.0).cpu().numpy(),
                'x1': scenes.frames(1.0).cpu().numpy(),
                'y': scenes.frames(0.5).cpu().numpy(),
                'time': np.full((batch, 1), 0.5, np.float32)})
  return out


def clip(seed: int, length: int, h: int, w: int, max_motion: float,
         device) -> List[np.ndarray]:
  """`length` uint8 frames (h, w, 3) of one scene at t = 0, 1, ...; the
  layers move by up to `max_motion` pixels a frame, the edge repeated
  where a layer runs out."""
  scenes = Scenes(seed, 'clip', 1, h, w, max_motion, device=device)
  return [to_uint8(scenes.frames(float(k)))[0].cpu().numpy()
          for k in range(length)]


def sample(seed: int, what: str, population: int, k: int) -> List[int]:
  """`k` distinct indices below `population`, drawn from the seed."""
  rng = np.random.default_rng(derived_seed(seed, 'sample', what))
  return sorted(rng.choice(population, size=min(k, population),
                           replace=False).tolist())
