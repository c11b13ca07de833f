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

A conv whose input is a channel concat may take the pieces instead, as a
list (the split form of the JAX package's ops/folded_conv.FoldableConv):
it convolves each piece with its slice of the weight's input channels,
sums the partial outputs in the compute dtype and adds the bias once, so
the concat is never written. `should_split` says which form a call site
takes. `Conv.conv` may also be given a weight a piece in place of the
slices of its own (models/fusion.py, whose inference input holds its
channels in another order than the weight's).

`Conv.conv_leaky` is a conv followed by leaky relu, the form of every
3x3 conv of the flow estimators and the fusion decoder. Where
ops/conv3x3_pieces.engages says so (on the card, bf16 or TF32, no
gradient asked for, no row shard, channel counts the kernel tiles) it
runs as one kernel that sums the pieces in one f32 accumulator, with no
rounding of partial outputs to the compute dtype, and adds the bias and
applies the activation in f32 before y rounds once (the concat form's
arithmetic, done once). Everywhere else it is `leaky_relu` of the conv
above, op for op.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3_pieces, rows


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


Pieces = Union[torch.Tensor, Sequence[torch.Tensor]]


def should_split(mode: str) -> bool:
  """Whether a concat conv runs split (Options.split_convs): unless the
  mode is 'off'. 'auto' splits on every device: the JAX package's default,
  and the form the H100 ran faster (tools/split_convs.py, NVIDIA H100 80GB
  HBM3 at 700 W), at 54.9 ms a 1080p bf16 pair against 58.8 for the
  concat (torch.cat 10.6 ms against 15.0), with the film_net-L1 step
  within noise (7.80 against 7.91 steps/s, runs spread 6.2-8.8). Where
  `Conv.conv_leaky` takes the kernel route (ops/conv3x3_pieces.py) both
  forms run the same arithmetic: the pieces summed in f32 in one
  accumulator, with no bf16 rounding of partial outputs."""
  return mode != 'off'


def conv_input(pieces: List[torch.Tensor], mode: str) -> Pieces:
  """The input of a conv on the channel concat of NHWC `pieces`: the list
  itself in the split form, else the concat."""
  if should_split(mode):
    return pieces
  return torch.cat(pieces, dim=-1)


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

  def forward(self, x: Pieces) -> torch.Tensor:
    """The conv of NHWC `x`, or of the channel concat of a list of NHWC
    pieces (the split form)."""
    shard = rows.current()
    k = self.weight.shape[-1]
    first = x if isinstance(x, torch.Tensor) else x[0]
    if k == 1 or shard is None or not shard.split(first):
      return self.conv(x)
    # TF's SAME: (k - 1) // 2 rows before, the rest after. The pieces of a
    # split conv take their halos in one exchange.
    above = (k - 1) // 2
    ext = shard.halo(x, above, k - 1 - above)
    return self.conv(ext)[:, above:above + first.shape[1]]

  def conv(self, x: Pieces,
           weights: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The conv of `x` (or of its pieces) alone, as if it were the whole
    frame; `weights`, one a piece, replace the slices of the layer's
    weight."""
    if isinstance(x, torch.Tensor):
      weight = self.weight if weights is None else weights[0]
      return self._conv(x, weight, self.bias)
    # JAX's order: the partial outputs summed in the compute dtype, then
    # the bias (ops/folded_conv.FoldableConv's split branch).
    y, offset = None, 0
    for k, piece in enumerate(x):
      c = piece.shape[-1]
      weight = (self.weight[:, offset:offset + c] if weights is None
                else weights[k])
      part = self._conv(piece, weight, None)
      y = part if y is None else y + part
      offset += c
    if weights is None and offset != self.weight.shape[1]:
      raise ValueError(f'pieces of {offset} channels for a conv of '
                       f'{self.weight.shape[1]} input channels')
    return y + self.bias.to(self.compute_dtype)

  def conv_leaky(self, x: Pieces,
                 weights: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
    """leaky_relu(self(x)), or of `self.conv(x, weights)` where `weights`
    replace the slices of the layer's weight. One kernel where
    ops/conv3x3_pieces.engages (it packs its copy from the same weights);
    else these ops."""
    pieces = [x] if isinstance(x, torch.Tensor) else list(x)
    if conv3x3_pieces.engages(pieces, self.weight, self.bias,
                              self.compute_dtype):
      return conv3x3_pieces.conv3x3_pieces_kernel(pieces, self.weight,
                                                  self.bias, weights)
    return leaky_relu(self(x) if weights is None else self.conv(x, weights))

  def _conv(self, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor = None) -> torch.Tensor:
    dtype = self.compute_dtype
    k = weight.shape[-1]
    x = x.to(dtype).permute(0, 3, 1, 2)
    if k % 2 == 0:
      # TF's SAME for an even kernel pads less before than after.
      lo = (k - 1) // 2
      x = F.pad(x, (lo, k - 1 - lo, lo, k - 1 - lo))
    y = F.conv2d(x, weight.to(dtype), None if bias is None else bias.to(dtype),
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
