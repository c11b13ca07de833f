"""Backward (inverse) bilinear warping: plain PyTorch and the CUDA kernel.

Semantics of frame_interpolation_tpu/ops/warp.py (the JAX counterpart of
`tensorflow_addons.image.dense_image_warp`):

  out[b, y, x] = bilinear_lookup(image[b], y + flow[b,y,x,1], x + flow[b,y,x,0])

with the tfa boundary rule: the floor of each query coordinate is clamped
into [0, size-2] and the fractional part (alpha) into [0, 1], so queries
out of bounds clamp to the edge pixels. Coordinates and blend weights are
f32 whatever the image dtype; the blend

  (1-ay)*((1-ax)*t00 + ax*t01) + ay*((1-ax)*t10 + ax*t11)

accumulates in f32 and rounds once to the image dtype, as the TPU window
kernel does (ops/warp_window.py).

`backward_warp` routes a CPU tensor to `backward_warp_plain` and a CUDA
tensor to the kernel in csrc/warp.cu; there is no other route.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

_KERNEL_DTYPES = {torch.bfloat16: 'fi_warp_bf16', torch.float32: 'fi_warp_f32'}


def _check_shapes(image: torch.Tensor, flow: torch.Tensor) -> None:
  if image.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
    raise ValueError(f'expected image (B, H, W, C) and flow (B, H, W, 2); '
                     f'got {tuple(image.shape)} and {tuple(flow.shape)}')
  if flow.shape[:3] != image.shape[:3]:
    raise ValueError(f'flow {tuple(flow.shape)} does not match image '
                     f'{tuple(image.shape)}')
  if image.shape[1] < 2 or image.shape[2] < 2:
    raise ValueError(f'the bilinear warp needs H, W >= 2; got '
                     f'{tuple(image.shape)}')


def query_coords(h: int, w: int, flow: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
  """Clamped integer corners (int64) and f32 weights for a (B, H, W, 2) flow.

  Exactly `_query_coords_full` of the JAX package: f32 query coordinates,
  floor clamped to [0, size-2], alpha clamped to [0, 1].
  """
  flow = flow.float()
  gy = torch.arange(flow.shape[1], dtype=torch.float32, device=flow.device)
  gx = torch.arange(flow.shape[2], dtype=torch.float32, device=flow.device)
  qy = gy[:, None] + flow[..., 1]
  qx = gx[None, :] + flow[..., 0]
  fy = torch.clamp(torch.floor(qy), 0.0, float(h - 2))
  fx = torch.clamp(torch.floor(qx), 0.0, float(w - 2))
  ay = torch.clamp(qy - fy, 0.0, 1.0)
  ax = torch.clamp(qx - fx, 0.0, 1.0)
  return fy.long(), fx.long(), ay, ax


def backward_warp_plain(image: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
  """The warp as plain tensor ops (any device): gather four taps, blend."""
  _check_shapes(image, flow)
  b, h, w, c = image.shape
  iy, ix, ay, ax = query_coords(h, w, flow)
  batch = torch.arange(b, device=image.device)[:, None, None] * (h * w)
  top = (batch + iy * w + ix).reshape(-1)
  pixels = image.reshape(b * h * w, c)
  ax = ax.reshape(-1, 1)
  ay = ay.reshape(-1, 1)
  t00 = pixels[top].float()
  t01 = pixels[top + 1].float()
  t10 = pixels[top + w].float()
  t11 = pixels[top + w + 1].float()
  out = ((1.0 - ay) * ((1.0 - ax) * t00 + ax * t01) +
         ay * ((1.0 - ax) * t10 + ax * t11))
  return out.reshape(b, h, w, c).to(image.dtype)


def backward_warp_kernel(image: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
  """The warp through csrc/warp.cu. CUDA tensors only; raises otherwise."""
  _check_shapes(image, flow)
  _kernels.require_cuda('backward_warp', image)
  # The kernel reads each pixel's (dx, dy) as one float2.
  _kernels.require_cuda('backward_warp', flow, alignment=8)
  if image.dtype not in _KERNEL_DTYPES:
    raise ValueError(f'backward_warp: the kernel takes bf16 or f32 images; '
                     f'got {image.dtype}')
  if flow.dtype != torch.float32:
    raise ValueError(f'backward_warp: the kernel takes an f32 flow; got '
                     f'{flow.dtype}')
  if flow.device != image.device:
    raise ValueError('backward_warp: image and flow on different devices')
  b, h, w, c = image.shape
  out = torch.empty_like(image)
  if out.numel() == 0:
    return out
  fn = getattr(_kernels.library(), _KERNEL_DTYPES[image.dtype])
  code = fn(image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
            _kernels.stream_of(image))
  _kernels.check('backward_warp', code)
  _kernels.LAUNCHES['warp'] += 1
  return out


def backward_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """Backward-warps `image` (B, H, W, C) with `flow` (B, H, W, 2; dx, dy).

  Returns the warped image in the image's shape and dtype. CPU tensors take
  the plain version, CUDA tensors the kernel.
  """
  if image.device.type == 'cpu':
    return backward_warp_plain(image, flow)
  return backward_warp_kernel(image, flow)
