"""conv3x3 + bias + leaky-relu, with an optional fused 2x2 average pool.

One function covers both TPU conv kernels of the feature extractor:
ops/conv_stack.py (the C=64 second conv of sub-level 0, with its pool) and
ops/conv_stack_wide.py (the C in {128, 256, 512} second convs, and the
rectangular first convs 128->256 and 256->512). Both compute

  y = leaky_relu(conv3x3_same(x, w) + b, 0.2)      accumulated in f32
  pooled = avg_pool_2x2(y)                          from the f32 values

and round y and pooled once to the input dtype. The leaky relu is
where(y >= 0, y, 0.2 y), JAX's form, whose gradient at exactly 0 is 1.
`conv3x3_leaky` runs the forward through `Conv3x3Leaky`: a CPU tensor takes
`conv3x3_leaky_plain` and a CUDA tensor the kernel in csrc/conv3x3.cu, and
there is no other route. On the card, bf16 runs on the tensor cores
(wgmma); f32 runs on them in TF32 under the flag that has cuDNN's own f32
convs run in TF32, and in exact f32 FMAs otherwise (ops/conv_weights.route,
`kernel_symbol`). The TF32 route rounds both operands to nearest TF32, as
cuDNN does: the weights when they are packed (ops/conv_weights.packed),
the activations in the kernel. The backward is plain PyTorch on every
device, as the JAX custom VJP differentiates the unfused composition with
XLA (ops/conv_stack.py _stack_diff_bwd, ops/conv_stack_wide.py
_wide_diff_bwd).

Tensors are NHWC, as in the JAX package; weights are PyTorch's OIHW
parameters in f32, cast to the input dtype as flax's promote_dtype does.

`stack_rows` runs the extractor's two convs on one shard's slab of a
row-sharded forward (ops/rows.py), as the JAX package's stack_rows runs
its fused stacks on each device's slab.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _kernels, conv_weights

# The kernel's tile width along both channel axes.
_CHANNEL_MULTIPLE = 64

# Rows each side of a slab for the extractor's two 3x3 convs: one for
# each, and even, so that the fused pool's row pairs stay the frame's.
HALO_ROWS = 2


def kernel_symbol(route: str) -> str:
  """The C entry point of csrc/conv3x3.cu for a route of
  ops/conv_weights.route: wgmma on bf16 ('bf16'), wgmma in TF32 ('tf32')
  or exact f32 FMAs ('f32')."""
  return f'fi_conv3x3_{route}'


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
  if x.dim() != 4:
    raise ValueError(f'expected x (N, H, W, Cin); got {tuple(x.shape)}')
  cin = x.shape[-1]
  if weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, 3, 3):
    raise ValueError(f'expected weight (Cout, {cin}, 3, 3); got '
                     f'{tuple(weight.shape)}')
  if tuple(bias.shape) != (weight.shape[0],):
    raise ValueError(f'expected bias ({weight.shape[0]},); got '
                     f'{tuple(bias.shape)}')


def conv3x3_leaky_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, pool: bool = False,
                        negative_slope: float = 0.2
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """The conv as plain tensor ops (any device).

  The conv runs in x's dtype (f32 accumulation in both PyTorch backends);
  bias, activation and pool run in f32 and each output rounds once.
  """
  _check(x, weight, bias)
  y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1)
  y = y.float() + bias.float()[:, None, None]
  y = torch.where(y >= 0, y, negative_slope * y)
  pooled = F.avg_pool2d(y, 2).to(x.dtype) if pool else None
  features = y.to(x.dtype)

  def nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()

  return nhwc(features), (nhwc(pooled) if pool else None)


def conv3x3_leaky_kernel(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, pool: bool = False,
                         negative_slope: float = 0.2
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """The conv through csrc/conv3x3.cu. CUDA tensors only; raises otherwise.

  Cin and Cout must be multiples of 64. The OIHW weights are repacked
  K-major to (Cout, 3, 3, Cin) in x's dtype, once per weight and route
  (ops/conv_weights.packed: kept until the weight changes; the TF32
  route's rounded to TF32); an f32 bias is passed as it is. The route is
  ops/conv_weights.route's; the exact f32 route takes a workspace of
  partial sums where the library splits K (`fi_conv3x3_f32_splits`). A
  launch of the TF32 route also counts as `conv3x3_tf32`.
  """
  _check(x, weight, bias)
  route = conv_weights.route(x.dtype)
  symbol = kernel_symbol(route)
  # TMA reads x and the weights in 16-byte aligned rows; the epilogue reads
  # the bias 16 bytes at a time.
  _kernels.require_cuda('conv3x3_leaky', x, alignment=16)
  if weight.device != x.device or bias.device != x.device:
    raise ValueError('conv3x3_leaky: x, weight and bias on different devices')
  n, h, w, cin = x.shape
  cout = weight.shape[0]
  if cin % _CHANNEL_MULTIPLE or cout % _CHANNEL_MULTIPLE:
    raise ValueError(f'conv3x3_leaky: the kernel takes channel counts that '
                     f'are multiples of {_CHANNEL_MULTIPLE}; got {cin}->{cout}')
  packed = conv_weights.packed(weight, x.dtype, route)
  bias32 = bias.detach().float().contiguous()
  _kernels.require_cuda('conv3x3_leaky', packed, bias32, alignment=16)
  features = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
  pooled = (torch.empty((n, h // 2, w // 2, cout), dtype=x.dtype,
                        device=x.device) if pool else None)
  if features.numel() == 0:
    return features, pooled
  lib = _kernels.library()
  stream = _kernels.stream_of(x)
  args = (x.data_ptr(), packed.data_ptr(), bias32.data_ptr(),
          features.data_ptr(), pooled.data_ptr() if pool else None)
  if route == 'f32':
    # The exact route splits K at the coarse levels into parts summed by a
    # second pass, in a workspace of one f32 output a part.
    splits = lib.fi_conv3x3_f32_splits(n, h, w, cin, cout)
    part = (torch.empty(splits * features.numel(), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    args += (part.data_ptr() if part is not None else None, splits)
  code = getattr(lib, symbol)(*args, n, h, w, cin, cout, negative_slope,
                              stream)
  _kernels.check('conv3x3_leaky', code)
  wide = not (cin == _CHANNEL_MULTIPLE and cout == _CHANNEL_MULTIPLE)
  _kernels.count_launch('conv3x3_wide' if wide else 'conv3x3_c64', stream)
  if route == 'tf32':
    _kernels.count_launch('conv3x3_tf32', stream)
  return features, pooled


class Conv3x3Leaky(torch.autograd.Function):
  """The fused conv with the gradient of its unfused composition.

  Forward: the kernel, or the plain version when `plain` (CPU tensors; the
  kernel's checks against its plain version on the card set it
  explicitly). Outputs: features, plus the pooled features when `pool`.
  Backward, plain PyTorch on every device: the pool's cotangent spread 2x2
  and divided by 4 joins the features' cotangent, the leaky mask comes
  from the saved output (y >= 0, JAX's tie rule), then conv2d's input and
  weight gradients in x's dtype and an f32 bias sum.
  """

  @staticmethod
  def forward(ctx, x, weight, bias, pool, negative_slope, plain):
    conv = conv3x3_leaky_plain if plain else conv3x3_leaky_kernel
    features, pooled = conv(x, weight, bias, pool, negative_slope)
    ctx.negative_slope = negative_slope
    ctx.save_for_backward(x, weight, features)
    ctx.bias_dtype = bias.dtype
    return (features, pooled) if pool else features

  @staticmethod
  def backward(ctx, grad_features, grad_pooled=None):
    x, weight, features = ctx.saved_tensors
    g = grad_features.float()
    if grad_pooled is not None:
      n, hp, wp, c = grad_pooled.shape
      spread = (grad_pooled.float() * 0.25).reshape(n, hp, 1, wp, 1, c)
      spread = spread.expand(n, hp, 2, wp, 2, c).reshape(n, 2 * hp, 2 * wp, c)
      g = g.clone()
      g[:, :2 * hp, :2 * wp] += spread
    g = torch.where(features >= 0, g, ctx.negative_slope * g)
    dtype = x.dtype
    g_nchw = g.to(dtype).permute(0, 3, 1, 2)
    x_nchw = x.permute(0, 3, 1, 2)
    grad_x = grad_weight = grad_bias = None
    if ctx.needs_input_grad[0]:
      grad_x = torch.nn.grad.conv2d_input(
          x_nchw.shape, weight.to(dtype), g_nchw, padding=1)
      grad_x = grad_x.permute(0, 2, 3, 1).contiguous()
    if ctx.needs_input_grad[1]:
      grad_weight = torch.nn.grad.conv2d_weight(
          x_nchw, weight.shape, g_nchw, padding=1).to(weight.dtype)
    if ctx.needs_input_grad[2]:
      grad_bias = g.sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
    return grad_x, grad_weight, grad_bias, None, None, None


def conv3x3_leaky(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  pool: bool = False, negative_slope: float = 0.2
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """leaky(conv3x3(x) + b) and, if `pool`, its 2x2 average pool.

  x: (N, H, W, Cin); weight: (Cout, Cin, 3, 3); bias: (Cout,). Returns
  (features (N, H, W, Cout), pooled (N, H//2, W//2, Cout) or None),
  differentiable in x, weight and bias. CPU tensors take the plain
  version, CUDA tensors the kernel.
  """
  out = Conv3x3Leaky.apply(x, weight, bias, pool, negative_slope,
                           x.device.type == 'cpu')
  return out if pool else (out, None)


def apply_valid_rows(y: torch.Tensor,
                     valid_rows: Tuple[int, int]) -> torch.Tensor:
  """Zeroes the rows of NHWC `y` outside [lo, hi) (ops/conv_stack.py
  apply_valid_rows): the halo rows that lie beyond the frame, where SAME
  padding gives the second conv zeros and not conv0 of zeros."""
  lo, hi = valid_rows
  if lo <= 0 and hi >= y.shape[1]:
    return y
  rows = torch.arange(y.shape[1], device=y.device)
  keep = ((rows >= lo) & (rows < hi))[None, :, None, None]
  return torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))


def stack_rows(head: torch.Tensor,
               first: Callable[[torch.Tensor], torch.Tensor],
               weight: torch.Tensor, bias: torch.Tensor, pool: bool, shard
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """An extractor sub-level's two convs on this shard's slab (inference).

  Counterpart of ops/conv_stack.py stack_rows. `head` is this shard's
  slab of a split level (ops/rows.RowShard); `first` is the sub-level's
  first conv with its activation, `weight`/`bias` its second conv's, run
  by `conv3x3_leaky` with the fused pool when `pool`. The slab takes
  HALO_ROWS rows from each neighbour (zeros beyond the frame), the first
  conv's output is zeroed on the rows beyond the frame, and the second's
  interior rows are the frame's rows: the whole-frame stack's, row for
  row. Returns (features, pooled or None) of the slab.
  """
  slab = head.shape[1]
  ext = shard.halo(head, HALO_ROWS, HALO_ROWS)
  top = shard.index * slab - HALO_ROWS  # global row of ext's first row
  y0 = apply_valid_rows(first(ext), (-top, shard.height(head.shape[2]) - top))
  features, pooled = conv3x3_leaky(y0.contiguous(), weight, bias, pool=pool)
  features = features[:, HALO_ROWS:HALO_ROWS + slab]
  if pooled is not None:
    pooled = pooled[:, HALO_ROWS // 2:(HALO_ROWS + slab) // 2]
  return features, pooled
