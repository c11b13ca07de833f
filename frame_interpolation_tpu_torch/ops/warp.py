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
the fourth (inference only, as in JAX). `backward_warp_into` writes the
warp into a slice of channels of a wider buffer (csrc/warp.cu, slice
mode), where models/film_net.py builds the fusion's input in place
(inference only).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _kernels
from . import rows as rows_lib

_KERNEL_DTYPES = {torch.bfloat16: 'fi_warp_bf16', torch.float32: 'fi_warp_f32'}
_INTO_DTYPES = {torch.bfloat16: 'fi_warp_into_bf16',
                torch.float32: 'fi_warp_into_f32'}
_ROWS_DTYPES = {torch.bfloat16: 'fi_warp_rows_bf16',
                torch.float32: 'fi_warp_rows_f32'}
_PLANES_DTYPES = {torch.bfloat16: 'fi_warp_planes_bf16',
                  torch.float32: 'fi_warp_planes_f32'}
_SPLAT_DTYPES = {torch.bfloat16: 'fi_splat_fixed_bf16',
                 torch.float32: 'fi_splat_fixed_f32'}


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


def _check_rows(slabs: Sequence[torch.Tensor], flow: torch.Tensor,
                row_offset: int, clamp_h: int) -> None:
  if not slabs or any(t.dim() != 4 for t in slabs) or flow.dim() != 4 or (
      flow.shape[-1] != 2):
    raise ValueError(f'expected slabs (B, rows, W, C) and a flow (B, Hout, '
                     f'W, 2); got {[tuple(t.shape) for t in slabs]} and '
                     f'{tuple(flow.shape)}')
  first = slabs[0]
  if any(t.shape != first.shape or t.dtype != first.dtype for t in slabs):
    raise ValueError(f'the slabs differ in shape or dtype: '
                     f'{[(tuple(t.shape), t.dtype) for t in slabs]}')
  if flow.shape[0] != first.shape[0] or flow.shape[2] != first.shape[2]:
    raise ValueError(f'flow {tuple(flow.shape)} does not match the slabs '
                     f'{tuple(first.shape)} in batch and width')
  if clamp_h != len(slabs) * first.shape[1]:
    raise ValueError(f'{len(slabs)} slabs of {first.shape[1]} rows do not '
                     f'make the frame\'s {clamp_h} rows')
  if clamp_h < 2 or first.shape[2] < 2:
    raise ValueError(f'the bilinear warp needs H, W >= 2; got clamp_h '
                     f'{clamp_h}, W {first.shape[2]}')
  if row_offset < 0 or row_offset + flow.shape[1] > clamp_h:
    raise ValueError(f'output rows [{row_offset}, '
                     f'{row_offset + flow.shape[1]}) leave the frame\'s '
                     f'{clamp_h} rows')


def backward_warp_rows_plain(slabs: Sequence[torch.Tensor],
                             flow: torch.Tensor, row_offset: int,
                             clamp_h: int) -> torch.Tensor:
  """The row-mode warp as plain tensor ops (any device).

  `slabs` are the frame's `clamp_h` rows as equal slabs (B, rows, W, C),
  in order; `flow` (B, Hout, W, 2) the output rows [row_offset,
  row_offset + Hout). Returns the whole-frame warp's rows [row_offset,
  row_offset + Hout).
  """
  _check_rows(slabs, flow, row_offset, clamp_h)
  frame = torch.cat([t.to(flow.device) for t in slabs], dim=1)
  return _blend_plain(frame, flow, row_offset=row_offset, src_row0=0,
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


def splat_fixed_order_plain(g: torch.Tensor,
                            flow: torch.Tensor) -> torch.Tensor:
  """The splat kernel's sums in its fixed order, as plain tensor ops (any
  device).

  Each accumulator element is the f32 sum, from 0, of its products
  w * g in the order of the source pixel's flat index, then the corner
  (00, 01, 10, 11), with one rounding a product and one an add: what
  csrc/splat.cu computes, bit for bit. The weights are
  `splat_plain`'s (the same f32 operations as the kernel's); a weight of
  exactly 0 adds nothing and takes no entry. Returns (B, H, W, C) f32.
  """
  top, ay, ax, _, _ = _taps(g, flow)
  b, h, w, c = g.shape
  n = b * h * w
  dest = torch.stack([top, top + 1, top + w, top + w + 1], dim=1).reshape(-1)
  weights = torch.cat([(1.0 - ay) * (1.0 - ax), (1.0 - ay) * ax,
                       ay * (1.0 - ax), ay * ax], dim=1).reshape(-1)
  source = torch.arange(n, device=g.device).repeat_interleave(4)
  keep = weights != 0
  dest, weights, source = dest[keep], weights[keep], source[keep]
  # The entries are in (pixel, corner) order: a stable sort by destination
  # keeps that order inside each destination's run.
  dest, order = torch.sort(dest, stable=True)
  weights, source = weights[order], source[order]
  counts = torch.bincount(dest, minlength=n)
  rank = torch.arange(dest.numel(), device=g.device) - (
      torch.cumsum(counts, 0) - counts)[dest]
  # Step r adds every destination's r-th product: one add an element.
  rank, order = torch.sort(rank, stable=True)
  dest, weights, source = dest[order], weights[order], source[order]
  steps = torch.bincount(rank).tolist() if rank.numel() else []
  gf = g.reshape(n, c).float()
  acc = torch.zeros((n, c), dtype=torch.float32, device=g.device)
  first = 0
  for size in steps:
    d = dest[first:first + size]
    acc[d] = acc[d] + (weights[first:first + size, None] *
                       gf[source[first:first + size]])
    first += size
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


def backward_warp_rows_kernel(slabs: Sequence[torch.Tensor],
                              flow: torch.Tensor, row_offset: int,
                              clamp_h: int) -> torch.Tensor:
  """The row-mode warp through csrc/warp.cu (`backward_warp_rows_plain`'s
  arguments): the kernel reads each tap from its row's slab by a table of
  the slabs' addresses, so nothing is copied. CUDA tensors on one device
  only; raises otherwise."""
  _check_rows(slabs, flow, row_offset, clamp_h)
  if len(slabs) > MAX_SLABS:
    raise ValueError(f'backward_warp_rows: the kernel takes at most '
                     f'{MAX_SLABS} slabs; got {len(slabs)}')
  _kernels.require_cuda('backward_warp_rows', *slabs)
  _kernels.require_cuda('backward_warp_rows', flow, alignment=8)
  image = slabs[0]
  if image.dtype not in _ROWS_DTYPES or flow.dtype != torch.float32:
    raise ValueError(f'backward_warp_rows: the kernel takes bf16 or f32 '
                     f'images and an f32 flow; got {image.dtype}, '
                     f'{flow.dtype}')
  if any(t.device != flow.device for t in slabs):
    raise ValueError('backward_warp_rows: slabs and flow on different '
                     'devices')
  b, slab_rows, w, c = image.shape
  h_out = flow.shape[1]
  out = torch.empty((b, h_out, w, c), dtype=image.dtype, device=image.device)
  if out.numel() == 0:
    return out
  fn = getattr(_kernels.library(), _ROWS_DTYPES[image.dtype])
  stream = _kernels.stream_of(image)
  table = (ctypes.c_void_p * len(slabs))(*(t.data_ptr() for t in slabs))
  code = fn(table, len(slabs), slab_rows, flow.data_ptr(), out.data_ptr(), b,
            h_out, w, c, row_offset, clamp_h, stream)
  _kernels.check('backward_warp_rows', code)
  _kernels.count_launch('warp_rows', stream)
  return out


# The most slabs the row-mode kernel takes (kMaxSlabs in csrc/warp.cu).
MAX_SLABS = 16


def backward_warp_rows(image: torch.Tensor, flow: torch.Tensor,
                       shard: 'rows_lib.RowShard') -> torch.Tensor:
  """The warp of this shard's slab of a split level (inference only).

  Counterpart of ops/warp_window.py backward_warp_window_rows. `image` and
  `flow` are this shard's slabs. One exchange hands every shard the
  others' slabs, and the row-mode warp reads each tap from the slab that
  holds its row: queries are the whole frame's (global rows, global
  clamp), so each slab is the whole-frame warp's rows bit for bit. The
  JAX kernel fetches a halo of the slab or the whole frame, chosen on the
  device by the flow's reach; reading the slabs where they lie needs
  neither the reach nor a copy, so nothing here reads the flow on the
  host. Slabs on another device are copied over first (meshes of several
  cards).
  """
  slab = image.shape[1]
  slabs = [s.to(image.device) for s in shard.exchange(image)]
  warp = (backward_warp_rows_plain if image.device.type == 'cpu'
          else backward_warp_rows_kernel)
  return warp(slabs, flow.contiguous(), shard.index * slab, slab * shard.n)


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


def _check_into(image: torch.Tensor, out: torch.Tensor, channel: int) -> None:
  if out.dim() != 4 or out.shape[:3] != image.shape[:3]:
    raise ValueError(f'backward_warp_into: out {tuple(out.shape)} does not '
                     f'match image {tuple(image.shape)} in B, H, W')
  if not 0 <= channel <= out.shape[-1] - image.shape[-1]:
    raise ValueError(f'backward_warp_into: channels [{channel}, '
                     f'{channel + image.shape[-1]}) leave out\'s '
                     f'{out.shape[-1]}')
  if out.dtype != image.dtype or out.device != image.device:
    raise ValueError(f'backward_warp_into: out is {out.dtype} on '
                     f'{out.device}, image {image.dtype} on {image.device}')
  if not out.is_contiguous():
    raise ValueError('backward_warp_into: out must be contiguous')


def backward_warp_into_kernel(image: torch.Tensor, flow: torch.Tensor,
                              out: torch.Tensor, channel: int) -> None:
  """`backward_warp_into` through csrc/warp.cu's slice mode. CUDA tensors
  only; raises otherwise."""
  _check_kernel_args('backward_warp_into', image, flow)
  _check_into(image, out, channel)
  _kernels.require_cuda('backward_warp_into', out)
  b, h, w, c = image.shape
  if image.numel() == 0:
    return
  fn = getattr(_kernels.library(), _INTO_DTYPES[image.dtype])
  stream = _kernels.stream_of(image)
  code = fn(image.data_ptr(), flow.data_ptr(),
            out.data_ptr() + channel * out.element_size(), out.shape[-1], b,
            h, w, c, stream)
  _kernels.check('backward_warp_into', code)
  _kernels.count_launch('warp_slice', stream)


def backward_warp_into(image: torch.Tensor, flow: torch.Tensor,
                       out: torch.Tensor, channel: int) -> None:
  """Backward-warps `image` (B, H, W, C) with `flow` into channels
  [channel, channel + C) of `out` (B, H, W, P), a contiguous buffer of the
  image's dtype on its device, and writes no other channel of it.

  The values are `backward_warp`'s, bit for bit; nothing is recorded for
  autograd, so the caller takes this route only where no gradient is
  asked for. A CUDA tensor runs the kernel's slice mode, which stores
  each pixel's C values at their place in the buffer (one `warp_slice`
  launch); a CPU tensor copies the plain warp into the slice.
  """
  if image.device.type != 'cpu':
    backward_warp_into_kernel(image, flow, out, channel)
    return
  _check_shapes(image, flow)
  _check_into(image, out, channel)
  out[..., channel:channel + image.shape[-1]] = backward_warp_plain(image,
                                                                    flow)


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

  Returns the (B, H, W, C) f32 accumulator, summed in a fixed order: each
  element is the f32 sum, from 0, of its products in the order of the
  source pixel's flat index, then the corner (00, 01, 10, 11), one
  rounding a product and one an add; the same bits on every run, equal to
  `splat_fixed_order_plain`, as the TPU kernels' sequential grid gives
  the JAX package. There is one route, whatever
  `torch.are_deterministic_algorithms_enabled()` says. The kernels write
  every element, and take a workspace of the size the library reports.
  """
  _check_kernel_args('splat', g, flow)
  b, h, w, c = g.shape
  acc = torch.empty(g.shape, dtype=torch.float32, device=g.device)
  if acc.numel() == 0:
    return acc
  lib = _kernels.library()
  stream = _kernels.stream_of(g)
  words = -(-lib.fi_splat_fixed_workspace_bytes(b, h, w) // 4)
  workspace = torch.empty(words, dtype=torch.int32, device=g.device)
  code = getattr(lib, _SPLAT_DTYPES[g.dtype])(
      g.data_ptr(), flow.data_ptr(), acc.data_ptr(), workspace.data_ptr(),
      b, h, w, c, stream)
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
