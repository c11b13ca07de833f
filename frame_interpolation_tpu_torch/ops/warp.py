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

The gradient is written out, as the JAX window VJP writes it
(ops/warp_window.py _bwd), and is not autograd of the plain forward:
  * the flow cotangent reduces the derivative planes (du, dv) against the
    output cotangent, per pixel over C (`flow_cotangent_from_planes`); the
    planes carry JAX's clip gradient of the raw alphas, 0.5 at exactly 0 or
    1, where autograd of torch.clamp would pass 1;
  * the image cotangent splats the output cotangent into the four clamped
    corners with the forward's weights, accumulated in f32.

Four functions have a plain version and a CUDA kernel each: the warp
(csrc/warp.cu), the planes (csrc/warp.cu, planes mode), the splat
(csrc/splat.cu) and the warp of a slab of output rows (csrc/warp.cu, row
mode). `backward_warp` runs the first three through `BackwardWarp`; a CPU
tensor takes the plain versions and a CUDA tensor the kernels, and there is
no other route. Inside a shard of a row-sharded forward (ops/rows.py) it
warps the shard's slab of a split level by `backward_warp_rows`, the
counterpart of ops/warp_window.py backward_warp_window_rows, which runs
the fourth (inference only, as in JAX).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from . import rows as rows_lib

_KERNEL_DTYPES = {torch.bfloat16: 'fi_warp_bf16', torch.float32: 'fi_warp_f32'}
_ROWS_DTYPES = {torch.bfloat16: 'fi_warp_rows_bf16',
                torch.float32: 'fi_warp_rows_f32'}
_PLANES_DTYPES = {torch.bfloat16: 'fi_warp_planes_bf16',
                  torch.float32: 'fi_warp_planes_f32'}
_SPLAT_DTYPES = {torch.bfloat16: 'fi_splat_bf16', torch.float32: 'fi_splat_f32'}


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


def query_coords(h: int, w: int, flow: torch.Tensor, row_offset: int = 0,
                 src_row0: int = 0, clamp_h: Optional[int] = None
                 ) -> Tuple[torch.Tensor, ...]:
  """Clamped corners, weights and raw offsets for a (B, Hout, W, 2) flow.

  Exactly `_query_coords_full` of the JAX package: f32 query coordinates,
  floor clamped to [0, size-2], alpha clamped to [0, 1]. Returns (iy, ix)
  int64, (ay, ax) f32 and the raw pre-clip offsets (ty, tx) f32.

  The output grid is the flow's; `h`, `w` are the source's extents. Row
  mode (ops/warp_window.py _forward): the flow's first row is global row
  `row_offset`; with `clamp_h` the rows clamp to the frame's `clamp_h`
  global rows and iy is then shifted into a source whose first row is
  global row `src_row0` (without it, the source is the whole frame).
  """
  flow = flow.float()
  gy = torch.arange(flow.shape[1], dtype=torch.float32, device=flow.device)
  gy = gy + float(row_offset)
  gx = torch.arange(flow.shape[2], dtype=torch.float32, device=flow.device)
  qy = gy[:, None] + flow[..., 1]
  qx = gx[None, :] + flow[..., 0]
  fy = torch.clamp(torch.floor(qy), 0.0,
                   float((h if clamp_h is None else clamp_h) - 2))
  fx = torch.clamp(torch.floor(qx), 0.0, float(w - 2))
  ty = qy - fy
  tx = qx - fx
  ay = torch.clamp(ty, 0.0, 1.0)
  ax = torch.clamp(tx, 0.0, 1.0)
  iy = fy.long()
  if clamp_h is not None:
    iy = iy - src_row0
  return iy, fx.long(), ay, ax, ty, tx


def _taps(image: torch.Tensor, flow: torch.Tensor, **rows):
  """Top-left tap rows (B*Hout*W,), coords reshaped to (B*Hout*W, 1)
  columns; `rows` are query_coords' row-mode arguments."""
  if not rows:
    _check_shapes(image, flow)
  b, h, w, _ = image.shape
  iy, ix, ay, ax, ty, tx = query_coords(h, w, flow, **rows)
  batch = torch.arange(b, device=image.device)[:, None, None] * (h * w)
  top = (batch + iy * w + ix).reshape(-1)
  return top, *(t.reshape(-1, 1) for t in (ay, ax, ty, tx))


def _blend_plain(image: torch.Tensor, flow: torch.Tensor,
                 **rows) -> torch.Tensor:
  top, ay, ax, _, _ = _taps(image, flow, **rows)
  b, h, w, c = image.shape
  pixels = image.reshape(b * h * w, c)
  t00 = pixels[top].float()
  t01 = pixels[top + 1].float()
  t10 = pixels[top + w].float()
  t11 = pixels[top + w + 1].float()
  out = ((1.0 - ay) * ((1.0 - ax) * t00 + ax * t01) +
         ay * ((1.0 - ax) * t10 + ax * t11))
  return out.reshape(flow.shape[:3] + (c,)).to(image.dtype)


def backward_warp_plain(image: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
  """The warp as plain tensor ops (any device): gather four taps, blend."""
  return _blend_plain(image, flow)


def _check_rows(image: torch.Tensor, flow: torch.Tensor, row_offset: int,
                clamp_h: int) -> None:
  if image.dim() != 4 or flow.dim() != 4 or flow.shape[-1] != 2:
    raise ValueError(f'expected image (B, Hsrc, W, C) and flow (B, Hout, '
                     f'W, 2); got {tuple(image.shape)} and '
                     f'{tuple(flow.shape)}')
  if flow.shape[0] != image.shape[0] or flow.shape[2] != image.shape[2]:
    raise ValueError(f'flow {tuple(flow.shape)} does not match image '
                     f'{tuple(image.shape)} in batch and width')
  if clamp_h < 2 or image.shape[2] < 2:
    raise ValueError(f'the bilinear warp needs H, W >= 2; got clamp_h '
                     f'{clamp_h}, W {image.shape[2]}')
  if row_offset < 0 or row_offset + flow.shape[1] > clamp_h:
    raise ValueError(f'output rows [{row_offset}, '
                     f'{row_offset + flow.shape[1]}) leave the frame\'s '
                     f'{clamp_h} rows')


def backward_warp_rows_plain(image: torch.Tensor, flow: torch.Tensor,
                             row_offset: int, src_row0: int,
                             clamp_h: int) -> torch.Tensor:
  """The row-mode warp as plain tensor ops (any device).

  `image` (B, Hsrc, W, C) holds global rows [src_row0, src_row0 + Hsrc) of
  a frame of `clamp_h` rows; `flow` (B, Hout, W, 2) the output rows
  [row_offset, row_offset + Hout). Returns the whole-frame warp's rows
  [row_offset, row_offset + Hout), provided every tap lies in the image
  (the caller's halo predicate: backward_warp_rows).
  """
  _check_rows(image, flow, row_offset, clamp_h)
  return _blend_plain(image, flow, row_offset=row_offset, src_row0=src_row0,
                      clamp_h=clamp_h)


def _clip_grad(t: torch.Tensor) -> torch.Tensor:
  """d clip(t, 0, 1) / dt with JAX's tie rule: 1 inside, 0.5 at 0 and 1."""
  inner = ((t > 0.0) & (t < 1.0)).float()
  edge = ((t == 0.0) | (t == 1.0)).float()
  return inner + 0.5 * edge


def warp_planes_plain(image: torch.Tensor, flow: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The flow-derivative planes (du, dv) as plain tensor ops (any device).

  du = d out / d flow_x = ((1-ay)(t01-t00) + ay(t11-t10)) * cg(tx) and
  dv = d out / d flow_y = (bot - top) * cg(ty), with cg the clip gradient
  of the raw offsets (`_raw_and_planes` of the JAX package). f32 math, one
  rounding to the image dtype per plane.
  """
  top, ay, ax, ty, tx = _taps(image, flow)
  b, h, w, c = image.shape
  pixels = image.reshape(b * h * w, c)
  t00 = pixels[top].float()
  t01 = pixels[top + 1].float()
  t10 = pixels[top + w].float()
  t11 = pixels[top + w + 1].float()
  du = ((1.0 - ay) * (t01 - t00) + ay * (t11 - t10)) * _clip_grad(tx)
  dv = (((1.0 - ax) * t10 + ax * t11) -
        ((1.0 - ax) * t00 + ax * t01)) * _clip_grad(ty)
  return (du.reshape(b, h, w, c).to(image.dtype),
          dv.reshape(b, h, w, c).to(image.dtype))


def splat_plain(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """The warp's image cotangent as plain tensor ops (any device).

  Adds each output pixel's cotangent, times the forward's four bilinear
  weights, into its four clamped source corners (`index_add_` into an f32
  (B*H*W, C) buffer). Returns (B, H, W, C) f32.
  """
  top, ay, ax, _, _ = _taps(g, flow)
  b, h, w, c = g.shape
  gf = g.reshape(b * h * w, c).float()
  acc = torch.zeros((b * h * w, c), dtype=torch.float32, device=g.device)
  acc.index_add_(0, top, (1.0 - ay) * (1.0 - ax) * gf)
  acc.index_add_(0, top + 1, (1.0 - ay) * ax * gf)
  acc.index_add_(0, top + w, ay * (1.0 - ax) * gf)
  acc.index_add_(0, top + w + 1, ay * ax * gf)
  return acc.reshape(b, h, w, c)


def flow_cotangent_from_planes(g: torch.Tensor, du: torch.Tensor,
                               dv: torch.Tensor,
                               flow_dtype: torch.dtype) -> torch.Tensor:
  """Per-pixel f32 sums over C of g*du and g*dv, as (B, H, W, 2)."""
  gf = g.float()
  return torch.stack([(gf * du.float()).sum(-1), (gf * dv.float()).sum(-1)],
                     dim=-1).to(flow_dtype)


def _check_kernel_args(name: str, image: torch.Tensor,
                       flow: torch.Tensor) -> None:
  _check_shapes(image, flow)
  _kernels.require_cuda(name, image)
  # The kernels read each pixel's (dx, dy) as one float2.
  _kernels.require_cuda(name, flow, alignment=8)
  if image.dtype not in _KERNEL_DTYPES:
    raise ValueError(f'{name}: the kernel takes bf16 or f32 images; got '
                     f'{image.dtype}')
  if flow.dtype != torch.float32:
    raise ValueError(f'{name}: the kernel takes an f32 flow; got '
                     f'{flow.dtype}')
  if flow.device != image.device:
    raise ValueError(f'{name}: image and flow on different devices')


def backward_warp_rows_kernel(image: torch.Tensor, flow: torch.Tensor,
                              row_offset: int, src_row0: int,
                              clamp_h: int) -> torch.Tensor:
  """The row-mode warp through csrc/warp.cu (`backward_warp_rows_plain`'s
  arguments). CUDA tensors only; raises otherwise."""
  _check_rows(image, flow, row_offset, clamp_h)
  _kernels.require_cuda('backward_warp_rows', image)
  _kernels.require_cuda('backward_warp_rows', flow, alignment=8)
  if image.dtype not in _ROWS_DTYPES or flow.dtype != torch.float32:
    raise ValueError(f'backward_warp_rows: the kernel takes bf16 or f32 '
                     f'images and an f32 flow; got {image.dtype}, '
                     f'{flow.dtype}')
  if flow.device != image.device:
    raise ValueError('backward_warp_rows: image and flow on different '
                     'devices')
  b, h_src, w, c = image.shape
  h_out = flow.shape[1]
  out = torch.empty((b, h_out, w, c), dtype=image.dtype, device=image.device)
  if out.numel() == 0:
    return out
  fn = getattr(_kernels.library(), _ROWS_DTYPES[image.dtype])
  stream = _kernels.stream_of(image)
  code = fn(image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h_src,
            h_out, w, c, row_offset, src_row0, clamp_h, stream)
  _kernels.check('backward_warp_rows', code)
  _kernels.count_launch('warp_rows', stream)
  return out


# The film_net pyramid resolves motion up to about 192 px (7 levels of up
# to 64 px each, reference models/film_net/options.py:30-34): a halo of
# k slabs with k * slab > 192 holds every realistic flow's taps.
MOTION_REACH_PX = 192


def halo_slabs(slab: int, n: int) -> int:
  """The row-sharded warp's halo in slabs on each side, or 0 for the
  whole frame (ops/warp_window.py _halo_slab_count): k slabs with
  k * slab > MOTION_REACH_PX, unless a shard would then take at least as
  many slabs (2k) from the others as the whole frame holds (n - 1)."""
  k = -(-MOTION_REACH_PX // slab)
  return 0 if 2 * k >= n - 1 else k


def backward_warp_rows(image: torch.Tensor, flow: torch.Tensor,
                       shard: 'rows_lib.RowShard') -> torch.Tensor:
  """The warp of this shard's slab of a split level (inference only).

  Counterpart of ops/warp_window.py backward_warp_window_rows. `image` and
  `flow` are this shard's slabs. The source rows the slab's taps can reach
  come from the other shards: `halo_slabs` slabs on each side (zeros
  beyond the frame, never read: the taps clamp to the frame) when every
  shard's largest |flow_y| is at most k * slab - 1, agreed by pmax so
  every shard takes the same branch, else the whole frame. Queries are
  the whole frame's (global rows, global clamp), so each slab is the
  whole-frame warp's rows bit for bit.
  """
  slab = image.shape[1]
  height = slab * shard.n
  row0 = shard.index * slab
  k = halo_slabs(slab, shard.n)
  if k and shard.pmax(flow[..., 1].abs().max().item()) <= k * slab - 1:
    source = shard.halo(image, k * slab, k * slab)
    src_row0 = row0 - k * slab
  else:
    source, src_row0 = shard.gather(image), 0
  warp = (backward_warp_rows_plain if image.device.type == 'cpu'
          else backward_warp_rows_kernel)
  return warp(source.contiguous(), flow.contiguous(), row0, src_row0,
              height)


def backward_warp_kernel(image: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
  """The warp through csrc/warp.cu. CUDA tensors only; raises otherwise."""
  _check_kernel_args('backward_warp', image, flow)
  b, h, w, c = image.shape
  out = torch.empty_like(image)
  if out.numel() == 0:
    return out
  fn = getattr(_kernels.library(), _KERNEL_DTYPES[image.dtype])
  stream = _kernels.stream_of(image)
  code = fn(image.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
            stream)
  _kernels.check('backward_warp', code)
  _kernels.count_launch('warp', stream)
  return out


def warp_planes_kernel(image: torch.Tensor, flow: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The planes through csrc/warp.cu. CUDA tensors only; raises otherwise."""
  _check_kernel_args('warp_planes', image, flow)
  b, h, w, c = image.shape
  du = torch.empty_like(image)
  dv = torch.empty_like(image)
  if du.numel() == 0:
    return du, dv
  fn = getattr(_kernels.library(), _PLANES_DTYPES[image.dtype])
  stream = _kernels.stream_of(image)
  code = fn(image.data_ptr(), flow.data_ptr(), du.data_ptr(), dv.data_ptr(),
            b, h, w, c, stream)
  _kernels.check('warp_planes', code)
  _kernels.count_launch('warp_planes', stream)
  return du, dv


def splat_kernel(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """The splat through csrc/splat.cu. CUDA tensors only; raises otherwise.

  Returns the (B, H, W, C) f32 accumulator.
  """
  _check_kernel_args('splat', g, flow)
  b, h, w, c = g.shape
  acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
  if acc.numel() == 0:
    return acc
  fn = getattr(_kernels.library(), _SPLAT_DTYPES[g.dtype])
  stream = _kernels.stream_of(g)
  code = fn(g.data_ptr(), flow.data_ptr(), acc.data_ptr(), b, h, w, c,
            stream)
  _kernels.check('splat', code)
  _kernels.count_launch('splat', stream)
  return acc


class BackwardWarp(torch.autograd.Function):
  """The warp with the JAX window VJP's gradient (ops/warp_window.py _bwd).

  `plain` picks the plain versions of the warp, the planes and the splat,
  and is False only for CUDA tensors (see `backward_warp`); the kernels'
  checks against their plain versions on the card set it explicitly.
  """

  @staticmethod
  def forward(ctx, image: torch.Tensor, flow: torch.Tensor,
              plain: bool) -> torch.Tensor:
    ctx.plain = plain
    ctx.save_for_backward(image, flow)
    warp = backward_warp_plain if plain else backward_warp_kernel
    return warp(image, flow)

  @staticmethod
  def backward(ctx, grad: torch.Tensor):
    image, flow = ctx.saved_tensors
    # Autograd may hand over any layout; the kernels take contiguous NHWC.
    grad = grad.contiguous()
    grad_image = grad_flow = None
    if ctx.needs_input_grad[1]:
      planes = warp_planes_plain if ctx.plain else warp_planes_kernel
      du, dv = planes(image, flow)
      grad_flow = flow_cotangent_from_planes(grad, du, dv, flow.dtype)
    if ctx.needs_input_grad[0]:
      splat = splat_plain if ctx.plain else splat_kernel
      grad_image = splat(grad, flow).to(image.dtype)
    return grad_image, grad_flow, None


def backward_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """Backward-warps `image` (B, H, W, C) with `flow` (B, H, W, 2; dx, dy).

  Returns the warped image in the image's shape and dtype, differentiable
  in both arguments. CPU tensors take the plain versions, CUDA tensors the
  kernels (forward and backward). Inside a shard of a row-sharded forward,
  a slab of a split level takes `backward_warp_rows` (no gradient).
  """
  shard = rows_lib.current()
  if shard is not None and shard.split(image):
    return backward_warp_rows(image, flow, shard)
  return BackwardWarp.apply(image, flow, image.device.type == 'cpu')
