"""The fusion decoder's upsampling conv: nearest x2, TF-SAME pad and the
2x2 conv in one kernel.

models/fusion.py decodes each finer level from the coarser one by a
nearest x2 upsample (ops/resize.resize_nearest) and the 2x2 `conv_{i}_0`,
whose TF SAME padding adds one zero row and one zero column after
(models/layers.Conv). As PyTorch ops that is a strided copy for each axis
of the upsample, a copy of the upsampled tensor into its padding and a
cuDNN conv that repeats three of every four reads. `upconv2x2_kernel`
(csrc/upconv2x2.cu) reads the coarse level and writes the conv's fine
output once. The JAX package has no such kernel: it leaves the step to XLA.

Both forms compute the same products. Output pixel (2i + a, 2j + b), phase
(a, b), takes from tap (dy, dx) the coarse pixel (i + (a + dy) // 2,
j + (b + dx) // 2) of x with one zero row and column after:

  y[:, a::2, b::2] = bias + sum over (dy, dx) of
                     x_pad[:, sy:sy + h, sx:sx + w] @ w[:, :, dy, dx].T

with (sy, sx) = ((a + dy) // 2, (b + dx) // 2). Every tap's products are
summed in f32 (no weights folded by phase, which would round other values
in bf16), the bias is added in the layer's dtype's value, and y rounds
once to x's dtype. `upconv2x2_plain` is that arithmetic in plain PyTorch,
the kernel's reference. On the card bf16 runs on the tensor cores, and f32
in TF32 where ops/conv_weights.route says so (where cuDNN's convs may run
in TF32), with both operands rounded to nearest TF32 as ops/conv_stack.py's
TF32 route rounds them. Exact f32 has no route here: its decoder keeps the
library ops. There is no backward: the decoder takes the kernel only on
its packed route, which records nothing for autograd.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _kernels, conv_weights

# The kernel's K step and N tile along both channel axes.
_CHANNEL_MULTIPLE = 64


def kernel_symbol(route: str) -> Optional[str]:
  """The C entry point of csrc/upconv2x2.cu for a route of
  ops/conv_weights.route, or None where there is none (exact f32)."""
  return {'bf16': 'fi_upconv2x2_bf16', 'tf32': 'fi_upconv2x2_tf32'}.get(route)


def supported(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
              size: Sequence[int]) -> bool:
  """Whether the kernel computes the 2x2 conv of `weight` in `dtype` on
  `resize_nearest(x, size)`: an exact x2 upsample, a kernel route for the
  dtype (under the current TF32 switch), and channel counts that are
  multiples of its K step and N tile. The device is not asked."""
  n, h, w, cin = x.shape
  return (tuple(int(s) for s in size) == (2 * h, 2 * w)
          and dtype in (torch.bfloat16, torch.float32)
          and x.dtype == dtype
          and kernel_symbol(conv_weights.route(dtype)) is not None
          and tuple(weight.shape[1:]) == (cin, 2, 2)
          and cin % _CHANNEL_MULTIPLE == 0
          and weight.shape[0] % _CHANNEL_MULTIPLE == 0)


def engages(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
            size: Sequence[int]) -> bool:
  """`supported`, on a CUDA tensor: where the decoder's packed route runs
  the kernel."""
  return x.device.type == 'cuda' and supported(x, weight, dtype, size)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
  if x.dim() != 4:
    raise ValueError(f'expected x (N, H, W, Cin); got {tuple(x.shape)}')
  cin = x.shape[-1]
  if weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, 2, 2):
    raise ValueError(f'expected weight (Cout, {cin}, 2, 2); got '
                     f'{tuple(weight.shape)}')
  if tuple(bias.shape) != (weight.shape[0],):
    raise ValueError(f'expected bias ({weight.shape[0]},); got '
                     f'{tuple(bias.shape)}')


def upconv2x2_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
  """The phase arithmetic as plain tensor ops (any device).

  x: (N, H, W, Cin); weight: (Cout, Cin, 2, 2), used in x's dtype; bias
  (Cout,), added in x's dtype's value. Sums in f32 (f64 for f64 x) and
  rounds once to x's dtype. Returns (N, 2H, 2W, Cout).
  """
  _check(x, weight, bias)
  acc = torch.float64 if x.dtype == torch.float64 else torch.float32
  n, h, w, _ = x.shape
  # One zero column and one zero row after: (C, W, H) pads, last dim first.
  padded = F.pad(x.to(acc), (0, 0, 0, 1, 0, 1))
  taps = weight.to(x.dtype).to(acc)
  b = bias.to(x.dtype).to(acc)
  out = x.new_empty((n, 2 * h, 2 * w, weight.shape[0]))
  for a in range(2):
    for bx in range(2):
      total = None
      for dy in range(2):
        for dx in range(2):
          sy, sx = (a + dy) // 2, (bx + dx) // 2
          term = padded[:, sy:sy + h, sx:sx + w] @ taps[:, :, dy, dx].T
          total = term if total is None else total + term
      out[:, a::2, bx::2] = (total + b).to(x.dtype)
  return out


def upconv2x2_kernel(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
  """The same through csrc/upconv2x2.cu. CUDA tensors only; raises
  otherwise, and where `kernel_symbol` has no route.

  Cin and Cout must be multiples of 64. The OIHW weights are repacked
  K-major to (Cout, 2, 2, Cin) in x's dtype, once per weight and route
  (ops/conv_weights.packed; the TF32 route's rounded to TF32); the bias
  goes in x's dtype's value, as f32. Counts `upconv2x2`.
  """
  _check(x, weight, bias)
  route = conv_weights.route(x.dtype)
  symbol = kernel_symbol(route)
  if symbol is None:
    raise ValueError(f'upconv2x2: the kernel takes bf16, or f32 while TF32 '
                     f'is allowed; got {x.dtype}')
  # TMA reads x and the weights in 16-byte aligned rows; the epilogue reads
  # the bias 16 bytes at a time.
  _kernels.require_cuda('upconv2x2', x, alignment=16)
  if weight.device != x.device or bias.device != x.device:
    raise ValueError('upconv2x2: x, weight and bias on different devices')
  n, h, w, cin = x.shape
  cout = weight.shape[0]
  if cin % _CHANNEL_MULTIPLE or cout % _CHANNEL_MULTIPLE:
    raise ValueError(f'upconv2x2: the kernel takes channel counts that are '
                     f'multiples of {_CHANNEL_MULTIPLE}; got {cin}->{cout}')
  packed = conv_weights.packed(weight, x.dtype, route)
  bias32 = bias.detach().to(x.dtype).float().contiguous()
  _kernels.require_cuda('upconv2x2', packed, bias32, alignment=16)
  out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
  if out.numel() == 0:
    return out
  stream = _kernels.stream_of(x)
  code = getattr(_kernels.library(), symbol)(
      x.data_ptr(), packed.data_ptr(), bias32.data_ptr(), out.data_ptr(), n,
      h, w, cin, cout, stream)
  _kernels.check('upconv2x2', code)
  _kernels.count_launch('upconv2x2', stream)
  return out
