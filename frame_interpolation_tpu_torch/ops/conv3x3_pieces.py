"""The flow estimators' and the fusion decoder's 3x3 convs in one kernel:
the conv of an input given in pieces, with bias and leaky relu.

models/flow_estimator.py's 3x3 convs and models/fusion.py's `conv_{i}_1`
and `conv_{i}_2` each take a leaky relu after them, and the first conv of
a flow estimator and each `conv_{i}_1` take their input as two pieces, the
channel concat they stand for never written (models/layers.py, the split
form). As library ops that is a cuDNN conv a piece, cuDNN's bias add, the
sum of the partial outputs and a leaky relu pass, each a full read and
write of a conv output. `conv3x3_pieces_kernel` (csrc/conv3x3_pieces.cu)
computes

  y = leaky(sum over pieces p of conv3x3_same(x_p, w_p) + b, 0.2)

in one launch: every piece, tap and channel summed in one f32 accumulator
(the concat form's arithmetic: no partial output is rounded), the bias in
the compute dtype's value and the activation in f32, and y rounded once to
the pieces' dtype. `conv3x3_pieces_plain` is that arithmetic in plain
PyTorch, the kernel's reference. The JAX package has no such kernel: it
leaves these convs to XLA.

On the card bf16 runs on the tensor cores, and f32 in TF32 where
ops/conv_weights.route says so (where cuDNN's convs may run in TF32), with
both operands rounded to nearest TF32 as ops/conv_stack.py's TF32 route
rounds them. Exact f32 has no route here. The kernel reads the weights as
one copy packed K-major, piece after piece, each piece's channels padded
with zero columns to the kernel's K chunk (ops/conv_weights.packed_pieces);
for the fusion's packed input that copy is packed from the weight gathered
into that input's channel order (models/fusion.gathered). There is no
backward.
`engages` says where models/layers.Conv.conv_leaky takes the kernel: on the
card, for a forward that records nothing for autograd, outside a row shard
(ops/rows.py), at channel counts the kernel tiles.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _kernels, conv_weights, rows

MAX_PIECES = 2
# A piece's channels: a multiple of 16 (the TMA rows' 16-byte steps and
# the K steps of both routes); Cout: of the narrowest N tile.
_CHANNEL_MULTIPLE = 16
_COUT_MULTIPLE = 32
# The kernel's K chunk by dtype, one 128-byte row of channels: each
# piece's K columns a tap in the packed weights are padded to it.
CHUNK_CHANNELS = {torch.bfloat16: 64, torch.float32: 32}


def kernel_symbol(route: str) -> Optional[str]:
  """The C entry point of csrc/conv3x3_pieces.cu for a route of
  ops/conv_weights.route, or None where there is none (exact f32)."""
  return {'bf16': 'fi_conv3x3_pieces_bf16',
          'tf32': 'fi_conv3x3_pieces_tf32'}.get(route)


def tile_plan(n: int, h: int, w: int, cout: int) -> Tuple[int, int]:
  """The tile plan the kernel takes for n images of h x w and `cout`
  output channels on the current CUDA device: (rows of 64 output columns a
  block, output channels a block). It follows the grid's fill of the SMs,
  not the dtype, and the card's checks cover each plan the main path
  takes."""
  rows, bn = ctypes.c_int(), ctypes.c_int()
  _kernels.check('conv3x3_pieces', _kernels.library().fi_conv3x3_pieces_plan(
      n, h, w, cout, ctypes.byref(rows), ctypes.byref(bn)))
  return rows.value, bn.value


def supported(pieces: Sequence[torch.Tensor], weight: torch.Tensor,
              dtype: torch.dtype) -> bool:
  """Whether the kernel computes the 3x3 conv of `weight` in `dtype` on the
  channel concat of NHWC `pieces`: one or two pieces in that dtype, of one
  N, H and W, each of a multiple of 16 channels; Cout a multiple of 32; a
  kernel route for the dtype (under the current TF32 switch). The device
  is not asked."""
  if not 1 <= len(pieces) <= MAX_PIECES or dtype not in CHUNK_CHANNELS:
    return False
  first = pieces[0]
  return (tuple(weight.shape[2:]) == (3, 3)
          and weight.shape[0] % _COUT_MULTIPLE == 0
          and kernel_symbol(conv_weights.route(dtype)) is not None
          and all(p.dim() == 4 and p.dtype == dtype
                  and p.shape[:3] == first.shape[:3] and p.shape[-1] > 0
                  and p.shape[-1] % _CHANNEL_MULTIPLE == 0 for p in pieces))


def eligible(pieces: Sequence[torch.Tensor], weight: torch.Tensor,
             bias: torch.Tensor, dtype: torch.dtype) -> bool:
  """`supported`, for a call the kernel may take: contiguous pieces on
  16-byte boundaries, nothing that asks autograd for a gradient (the
  kernel has no backward), and no row shard (a slab's conv takes rows from
  its neighbours: models/layers.Conv.forward). The device is not asked."""
  return (rows.current() is None
          and not (torch.is_grad_enabled() and any(
              t.requires_grad for t in (*pieces, weight, bias)))
          and supported(pieces, weight, dtype)
          and all(p.is_contiguous() and p.data_ptr() % 16 == 0
                  for p in pieces))


def engages(pieces: Sequence[torch.Tensor], weight: torch.Tensor,
            bias: torch.Tensor, dtype: torch.dtype) -> bool:
  """`eligible`, on CUDA pieces: where models/layers.Conv.conv_leaky runs
  the kernel."""
  return pieces[0].device.type == 'cuda' and eligible(pieces, weight, bias,
                                                      dtype)


def _check(pieces: Sequence[torch.Tensor], weight: torch.Tensor,
           bias: torch.Tensor) -> None:
  if not 1 <= len(pieces) <= MAX_PIECES:
    raise ValueError(f'expected 1 to {MAX_PIECES} pieces; got {len(pieces)}')
  first = pieces[0]
  for p in pieces:
    if p.dim() != 4 or p.shape[:3] != first.shape[:3] or (
        p.dtype != first.dtype):
      raise ValueError('expected pieces (N, H, W, C) of one N, H, W and '
                       f'dtype; got {[tuple(q.shape) for q in pieces]}')
  if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
    raise ValueError(f'expected weight (Cout, Cin, 3, 3); got '
                     f'{tuple(weight.shape)}')
  if tuple(bias.shape) != (weight.shape[0],):
    raise ValueError(f'expected bias ({weight.shape[0]},); got '
                     f'{tuple(bias.shape)}')


def conv3x3_pieces_plain(pieces: Sequence[torch.Tensor],
                         weights: Sequence[torch.Tensor], bias: torch.Tensor,
                         negative_slope: float = 0.2) -> torch.Tensor:
  """The kernel's arithmetic as plain tensor ops (any device).

  pieces: NHWC, one dtype; weights: one OIHW weight a piece, used in the
  pieces' dtype; bias (Cout,), added in that dtype's value. Sums the
  pieces' convs, the bias and the activation in f32 (f64 for f64 pieces)
  and rounds once to the pieces' dtype. Returns (N, H, W, Cout).
  """
  dtype = pieces[0].dtype
  acc = torch.float64 if dtype == torch.float64 else torch.float32
  y = None
  for x, weight in zip(pieces, weights, strict=True):
    part = F.conv2d(x.permute(0, 3, 1, 2).to(acc),
                    weight.to(dtype).to(acc), padding=1)
    y = part if y is None else y + part
  y = y + bias.to(dtype).to(acc)[:, None, None]
  y = torch.where(y >= 0, y, negative_slope * y)
  return y.to(dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3_pieces_kernel(pieces: Sequence[torch.Tensor],
                          weight: torch.Tensor, bias: torch.Tensor,
                          weights: Optional[Sequence[torch.Tensor]] = None,
                          negative_slope: float = 0.2) -> torch.Tensor:
  """The same through csrc/conv3x3_pieces.cu. CUDA tensors only; raises
  otherwise, and where `kernel_symbol` has no route.

  pieces: one or two NHWC tensors of one N, H, W and dtype, each of a
  multiple of 16 channels, contiguous; weight: the layer's OIHW (Cout,
  Cin, 3, 3), Cout a multiple of 32, cut into the pieces' channels, or
  `weights`, one a piece, in place of its slices (models/fusion.gathered);
  bias (Cout,). The packed copy is made once per weight, cut and route
  (ops/conv_weights.packed_pieces); the bias goes in the pieces' dtype's
  value, as f32, a copy also made once (a launch then runs the kernel
  alone). Counts `conv3x3_pieces`.
  """
  pieces = list(pieces)
  _check(pieces, weight, bias)
  first = pieces[0]
  route = conv_weights.route(first.dtype)
  symbol = kernel_symbol(route)
  if symbol is None:
    raise ValueError('conv3x3_pieces: the kernel takes bf16, or f32 while '
                     f'TF32 is allowed; got {first.dtype}')
  # TMA reads the pieces and the weights in 16-byte aligned rows; the
  # epilogue reads the bias 16 bytes at a time.
  _kernels.require_cuda('conv3x3_pieces', *pieces, alignment=16)
  if weight.device != first.device or bias.device != first.device:
    raise ValueError('conv3x3_pieces: pieces, weight and bias on different '
                     'devices')
  channels = tuple(p.shape[-1] for p in pieces)
  cout = weight.shape[0]
  if cout % _COUT_MULTIPLE or any(c % _CHANNEL_MULTIPLE for c in channels):
    raise ValueError(f'conv3x3_pieces: the kernel takes pieces of multiples '
                     f'of {_CHANNEL_MULTIPLE} channels and Cout a multiple '
                     f'of {_COUT_MULTIPLE}; got {channels}->{cout}')
  chunk = CHUNK_CHANNELS[first.dtype]
  packed = conv_weights.packed_pieces(weight, channels, first.dtype, route,
                                      chunk, weights)
  k = sum(9 * (-(-c // chunk) * chunk) for c in channels)
  if tuple(packed.shape) != (cout, k):
    raise ValueError(f'conv3x3_pieces: weights packed {tuple(packed.shape)} '
                     f'for pieces of {channels} channels, Cout {cout}')
  bias32 = conv_weights.derived(
      bias, ('bias', first.dtype),
      lambda: bias.detach().to(first.dtype).float().contiguous())
  _kernels.require_cuda('conv3x3_pieces', packed, bias32, alignment=16)
  n, h, w = first.shape[:3]
  out = torch.empty((n, h, w, cout), dtype=first.dtype, device=first.device)
  if out.numel() == 0:
    return out
  second = pieces[1] if len(pieces) > 1 else None
  stream = _kernels.stream_of(first)
  code = getattr(_kernels.library(), symbol)(
      first.data_ptr(), None if second is None else second.data_ptr(),
      channels[0], 0 if second is None else channels[1], packed.data_ptr(),
      bias32.data_ptr(), out.data_ptr(), n, h, w, cout,
      float(negative_slope), stream)
  _kernels.check('conv3x3_pieces', code)
  _kernels.count_launch('conv3x3_pieces', stream)
  return out
