"""The conv layer shared by the port's models.

PyTorch counterpart of the flax `nn.Conv` (via FoldableConv) the JAX
models use: 'SAME' padding, parameters kept in f32, and input, kernel and
bias cast to the layer's compute dtype before the conv (flax's
promote_dtype). Tensors stay NHWC at the interface; the conv itself runs on
the channels_last NCHW view of the same memory, so no layout copy is made.
Inside a shard of a row-sharded forward (ops/rows.py) a conv on a slab
takes the rows its window reaches from the neighbouring slabs, the halo
GSPMD adds in JAX: 3x3 SAME one row on each side, the fusion's 2x2
TF-SAME one row below, 1x1 none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import rows


class _LeakyRelu(torch.autograd.Function):
  """F.leaky_relu's values (one kernel) with jax.nn.leaky_relu's gradient,
  which is 1 at exactly 0 where F.leaky_relu's is the slope. The mask comes
  from the saved output: leaky relu keeps the sign, so y >= 0 where x >= 0
  (but for a negative subnormal x whose product underflows to -0)."""

  @staticmethod
  def forward(ctx, x):
    y = F.leaky_relu(x, 0.2)
    ctx.save_for_backward(y)
    return y

  @staticmethod
  def backward(ctx, grad):
    y, = ctx.saved_tensors
    return torch.where(y >= 0, grad, 0.2 * grad)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
  """leaky relu with slope 0.2 and JAX's tie rule (gradient 1 at 0)."""
  return _LeakyRelu.apply(x)


class Conv(nn.Module):
  """A kernel_size x kernel_size 'SAME' conv on NHWC tensors.

  `weight` is (Cout, Cin, kh, kw) (PyTorch's OIHW; the flax tree holds the
  same values as HWIO, see io/params_io.py) and `bias` is (Cout,).
  """

  def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
               compute_dtype: torch.dtype):
    super().__init__()
    self.weight = nn.Parameter(
        torch.zeros(out_channels, in_channels, kernel_size, kernel_size))
    self.bias = nn.Parameter(torch.zeros(out_channels))
    self.compute_dtype = compute_dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shard = rows.current()
    k = self.weight.shape[-1]
    if k == 1 or shard is None or not shard.split(x):
      return self.conv(x)
    # TF's SAME: (k - 1) // 2 rows before, the rest after.
    above = (k - 1) // 2
    ext = shard.halo(x, above, k - 1 - above)
    return self.conv(ext)[:, above:above + x.shape[1]]

  def conv(self, x: torch.Tensor) -> torch.Tensor:
    """The conv of `x` alone, as if it were the whole frame."""
    dtype = self.compute_dtype
    k = self.weight.shape[-1]
    x = x.to(dtype).permute(0, 3, 1, 2)
    if k % 2 == 0:
      # TF's SAME for an even kernel pads less before than after.
      lo = (k - 1) // 2
      x = F.pad(x, (lo, k - 1 - lo, lo, k - 1 - lo))
    y = F.conv2d(x, self.weight.to(dtype), self.bias.to(dtype),
                 padding=k // 2 if k % 2 else 0)
    return y.permute(0, 2, 3, 1).contiguous()

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator) -> None:
    """flax's lecun_normal kernel init (truncated at 2 sigma), zero bias."""
    fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
    # 0.8796... is the stddev of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    self.bias.zero_()
