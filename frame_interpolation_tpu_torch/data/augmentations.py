"""Data augmentations as batched tensor transforms, run on the device.

Port of frame_interpolation_tpu/data/augmentations.py (itself the
reference's training/augmentation_lib.py): random 90-degree rotations,
left-right flips, +-45-degree bilinear rotations with constant-0 fill,
temporal reversal, and the flow-aware variants (flow_rot90, rotate_flow,
flow_flip) that counter-rotate the (u, v) vectors.

The deterministic transforms keep the JAX signatures ((H, W, C) images;
`rotate_image` also takes a (B, H, W, C) batch with one angle per example).
The random ones draw one value per example from a `torch.Generator`, so
every example is augmented independently and one seed gives one sequence
of batches. Each is two steps: `draw_augmentations` makes every draw of a
step where the generator lives (the host for a CPU generator), in a fixed
order, as one (rows, B) f32 tensor; `apply_drawn` applies them on the
batch's device with tensor ops alone, reading the draws from that tensor
(rot90 selects among the four rotations of the square crop by example).
So the application needs no host sync and runs inside a captured train
step (training/train_lib.py), the draws crossing to the card as one small
copy. `apply_data_augmentation` does both.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

Batch = Dict[str, torch.Tensor]
_IMAGE_KEYS = ('x0', 'x1', 'y')


def _rot90_single(image: torch.Tensor, k: int) -> torch.Tensor:
  """tf.image.rot90 parity (counter-clockwise k times) for (H, W, C)."""
  k = int(k) % 4
  if k == 1:
    return image.transpose(0, 1).flip(0)
  if k == 2:
    return image.flip(0).flip(1)
  if k == 3:
    return image.transpose(0, 1).flip(1)
  return image


def _bilinear_sample_constant(image: torch.Tensor, qy: torch.Tensor,
                              qx: torch.Tensor) -> torch.Tensor:
  """Bilinear lookup of (B, H, W, C) at (B, H, W) points, 0 outside."""
  b, h, w, c = image.shape
  fy = torch.floor(qy)
  fx = torch.floor(qx)
  ay = (qy - fy)[..., None]
  ax = (qx - fx)[..., None]
  iy = fy.long()
  ix = fx.long()
  pixels = image.reshape(b * h * w, c)
  base = torch.arange(b, device=image.device)[:, None, None] * (h * w)

  def tap(dy, dx):
    yy = iy + dy
    xx = ix + dx
    valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
    index = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    values = pixels[index.reshape(-1)].reshape(b, qy.shape[1], qy.shape[2],
                                               c)
    return torch.where(valid, values, torch.zeros((), dtype=image.dtype,
                                                  device=image.device))

  top = tap(0, 0) * (1 - ax) + tap(0, 1) * ax
  bot = tap(1, 0) * (1 - ax) + tap(1, 1) * ax
  return top * (1 - ay) + bot * ay


def _rotation_queries(h: int, w: int, angle: torch.Tensor):
  """Input coordinates read by each output pixel under a ccw rotation.

  angle: (B,) f32. Returns (qy, qx), each (B, H, W) f32.
  """
  cy = (h - 1) / 2.0
  cx = (w - 1) / 2.0
  gy = (torch.arange(h, dtype=torch.float32, device=angle.device) - cy)
  gx = (torch.arange(w, dtype=torch.float32, device=angle.device) - cx)
  gy = gy[None, :, None]
  gx = gx[None, None, :]
  cos = torch.cos(angle)[:, None, None]
  sin = torch.sin(angle)[:, None, None]
  # Inverse rotation of the output grid (image content turns ccw).
  qx = cos * gx - sin * gy + cx
  qy = sin * gx + cos * gy + cy
  return qy, qx


def _as_angles(angle, batch: int, device) -> torch.Tensor:
  angle = torch.as_tensor(angle, dtype=torch.float32).to(device)
  return angle.reshape(-1).expand(batch) if angle.numel() == 1 else angle


def rotate_image(image: torch.Tensor, angle) -> torch.Tensor:
  """Rotates by `angle` radians counter-clockwise about the centre.

  Bilinear sampling with constant-0 fill (tfa_image.rotate parity,
  reference augmentation_lib.py:83-88, 189-193). `image` is (H, W, C) with
  a scalar angle, or (B, H, W, C) with a scalar or (B,) angles.
  """
  single = image.dim() == 3
  images = image[None] if single else image
  b, h, w, _ = images.shape
  qy, qx = _rotation_queries(h, w, _as_angles(angle, b, images.device))
  out = _bilinear_sample_constant(images, qy, qx)
  return out[0] if single else out


def rotate_flow_vectors(flow: torch.Tensor, angle) -> torch.Tensor:
  """Rotates each (u, v) flow vector by `angle` radians.

  Image y points down, so v = -y and the rotation becomes
  rot_u = cos*u + sin*v, rot_v = -sin*u + cos*v (reference
  augmentation_lib.py:27-54).
  """
  angle = torch.as_tensor(angle, dtype=torch.float32).to(flow.device)
  u = flow[..., 0:1]
  v = flow[..., 1:2]
  cos, sin = torch.cos(angle), torch.sin(angle)
  return torch.cat([cos * u + sin * v, -sin * u + cos * v], dim=-1)


def flow_rot90(flow: torch.Tensor, k: int) -> torch.Tensor:
  """Rotates a flow map (H, W, 2) by k*90 degrees, counter-rotating
  vectors."""
  angle = torch.tensor(float(k), dtype=torch.float32) * (math.pi / 2.0)
  return rotate_flow_vectors(_rot90_single(flow, k), angle)


def _reflect(q: torch.Tensor, size: int) -> torch.Tensor:
  """Reflects coordinates into [0, size-1] (tfa 'reflect' fill mode)."""
  period = 2.0 * (size - 1)
  q = torch.remainder(q.abs(), period)
  return torch.where(q > size - 1, period - q, q)


def rotate_flow(flow: torch.Tensor, angle) -> torch.Tensor:
  """Rotates a flow map (H, W, 2) by `angle` radians, counter-rotating
  vectors; out-of-bounds queries reflect (reference
  augmentation_lib.py:83-88)."""
  h, w, _ = flow.shape
  angles = _as_angles(angle, 1, flow.device)
  qy, qx = _rotation_queries(h, w, angles)
  rotated = _bilinear_sample_constant(flow[None], _reflect(qy, h),
                                      _reflect(qx, w))[0]
  return rotate_flow_vectors(rotated, angles[0])


def flow_flip(flow: torch.Tensor) -> torch.Tensor:
  """Left-right flips a flow map (H, W, 2) and negates the u component."""
  flow = flow.flip(1)
  return torch.cat([-flow[..., 0:1], flow[..., 1:2]], dim=-1)


# ---- random augmentations: one draw per example -----------------------------


class Augmentation(NamedTuple):
  """A random augmentation: `draw(generator, batch)` returns its `rows`
  rows of draws, each (batch,), in order; `apply(images, rows)` applies
  them."""
  rows: int
  draw: Callable[[torch.Generator, int], List[torch.Tensor]]
  apply: Callable[[Batch, torch.Tensor], Batch]


def _coin(generator: torch.Generator, batch: int) -> torch.Tensor:
  return torch.randint(0, 2, (batch,), generator=generator,
                       device=generator.device)


def _where_examples(choice: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
  return torch.where((choice != 0)[:, None, None, None], a, b)


def _rot90_batch(images: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
  """Rotates each square example of (B, H, H, C) counter-clockwise k[b]
  times: the four rotations of the batch, selected by example."""
  rotations = (images, images.transpose(1, 2).flip(1),
               images.flip(1).flip(2), images.transpose(1, 2).flip(2))
  out = rotations[0]
  for turns in (1, 2, 3):
    out = _where_examples(k == turns, rotations[turns], out)
  return out


def _draw_rot90(generator: torch.Generator, batch: int):
  return [torch.randint(0, 4, (batch,), generator=generator,
                        device=generator.device)]


def _apply_rot90(images: Batch, rows: torch.Tensor) -> Batch:
  first = next(iter(images.values()))
  if first.shape[1] != first.shape[2]:
    raise ValueError('random rot90 needs square images (apply the training '
                     f'crop first); got {tuple(first.shape)}')
  return {name: _rot90_batch(img, rows[0]) for name, img in images.items()}


def _apply_flip(images: Batch, rows: torch.Tensor) -> Batch:
  return {name: _where_examples(rows[0], img.flip(2), img)
          for name, img in images.items()}


def _draw_rotate(generator: torch.Generator, batch: int):
  # The coin, then the angle's uniform draw.
  return [_coin(generator, batch),
          torch.rand((batch,), generator=generator, device=generator.device)]


def _apply_rotate(images: Batch, rows: torch.Tensor) -> Batch:
  angle = (rows[1] * 0.5 - 0.25) * math.pi
  return {name: rotate_image(img, angle * rows[0])
          for name, img in images.items()}


def _apply_reverse(images: Batch, rows: torch.Tensor) -> Batch:
  out = dict(images)
  if 'x0' in images and 'x1' in images:
    out['x0'] = _where_examples(rows[0], images['x1'], images['x0'])
    out['x1'] = _where_examples(rows[0], images['x0'], images['x1'])
  return out


def _draw_coin(generator: torch.Generator, batch: int):
  return [_coin(generator, batch)]


_REGISTRY: Dict[str, Augmentation] = {
    'random_image_rot90': Augmentation(1, _draw_rot90, _apply_rot90),
    'random_flip': Augmentation(1, _draw_coin, _apply_flip),
    'random_rotate': Augmentation(2, _draw_rotate, _apply_rotate),
    'random_reverse': Augmentation(1, _draw_coin, _apply_reverse),
}


def data_augmentations(names: Sequence[str]) -> List[Augmentation]:
  """Name registry parity (reference augmentation_lib.py:197-220)."""
  fns = []
  for name in names:
    if name not in _REGISTRY:
      raise AttributeError(f'Invalid augmentation function {name}')
    fns.append(_REGISTRY[name])
  return fns


def draw_augmentations(augmentations: Sequence[Augmentation],
                       generator: torch.Generator,
                       batch_size: int) -> torch.Tensor:
  """Every draw of one step, in the augmentations' order, as one
  (rows, batch_size) f32 tensor where the generator lives (each draw is
  an integer below 4 or an f32 uniform, so f32 holds it exactly)."""
  rows = [row.float() for aug in augmentations
          for row in aug.draw(generator, batch_size)]
  if not rows:
    return torch.zeros((0, batch_size), device=generator.device)
  return torch.stack(rows)


def apply_drawn(augmentations: Sequence[Augmentation], draws: torch.Tensor,
                batch: Batch) -> Batch:
  """Applies the augmentations with `draws` (from `draw_augmentations`,
  on the batch's device) to the (B, H, W, C) 'x0', 'x1' and 'y' of
  `batch`; other keys pass through untouched. Tensor ops alone, on the
  device: no host sync."""
  if not augmentations:
    return batch
  images = {k: batch[k] for k in _IMAGE_KEYS if k in batch}
  row = 0
  for aug in augmentations:
    images = aug.apply(images, draws[row:row + aug.rows])
    row += aug.rows
  out = dict(batch)
  out.update(images)
  return out


def apply_data_augmentation(augmentations: Sequence[Augmentation],
                            generator: torch.Generator,
                            batch: Batch) -> Batch:
  """Applies augmentations to a batch, independently per example.

  Args:
    augmentations: from `data_augmentations`.
    generator: the source of every random draw (advanced in place).
    batch: dict with (B, H, W, C) tensors under 'x0', 'x1', 'y' (other keys
      pass through untouched).

  Returns:
    The augmented batch, same shapes.
  """
  if not augmentations:
    return batch
  first = next(batch[k] for k in _IMAGE_KEYS if k in batch)
  draws = draw_augmentations(augmentations, generator, first.shape[0])
  return apply_drawn(augmentations, draws.to(first.device), batch)


def augment_batch(generator: torch.Generator, batch: Batch,
                  names: Sequence[str]) -> Batch:
  """`apply_data_augmentation` keyed by augmentation names: the step's
  draws from `generator`, then their application on the batch's device
  (frame_interpolation_tpu/data/augmentations.py augment_batch)."""
  return apply_data_augmentation(data_augmentations(tuple(names)), generator,
                                 batch)
