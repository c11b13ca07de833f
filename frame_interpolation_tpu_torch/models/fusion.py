"""U-Net style fusion decoder for film_net.

Port of frame_interpolation_tpu/models/fusion.py: from the coarsest
aligned-feature level, each finer level does nearest x2 upsampling, a 2x2
conv (TF-asymmetric SAME padding), a concat with the skip connection and
two 3x3 convs with leaky-relu (the first of them takes the skip and the
upsampled features as two pieces where `Options.split_convs` splits, and
the concat is not built); a final f32 1x1 conv produces RGB. The
coarsest level has no convs. Filter counts double per finer level up to
`specialized_levels`.

The decoder takes the aligned pyramid in one of two channel layouts.
`forward` takes the JAX package's, the concat layout: at a level whose
frames have C feature channels, the 2C + 10 channels

  [image 0 (3), features 0 (C), image 1 (3), features 1 (C),
   backward flow (2), forward flow (2)]

that models/film_net.py concatenates where a gradient is asked for or a
row shard is installed. `forward_in_place` builds the pyramid itself, in
the packed layout (`packed_layout`), and decodes it: each level is one
buffer of

  [features 0 (C), features 1 (C), image 0 (3), image 1 (3),
   backward flow (2), forward flow (2), zeros]

to P = 2C + 10 rounded up to a multiple of 8 channels (2C + 16 at the
released widths: 144, 400, 912, 1936, 1936), whose channels the four
warps (ops/warp.backward_warp_into), the two flows and a fill of the pad
write, each its own and none twice. So no concat copies a warped level
again, the feature slices start on 16-byte boundaries (the warp's vector
route) and cuDNN takes the buffer without padding it to a multiple of 8
first. The convs that read the aligned pyramid, each `conv_{i}_1` (its
first piece) and the coarsest level's `conv_{levels-2}_0` (after the
nearest upsample), then take their weight with its input channels
gathered into the packed order (`packed_order`), with zero columns at the
pad (`gathered`: made once a weight, order and dtype, and kept while the
weight is unchanged). A zero column adds exact zeros, so the convs
compute the same sums, in an order cuDNN may choose otherwise. On the
card the packed route also runs each finer level's upsampling step, the
nearest x2 and `conv_{i}_0` with its TF-SAME padding, as one kernel
(ops/upconv2x2.py) where that kernel takes the call: bf16, or f32 while
TF32 is allowed, and channel counts it tiles, so every level but the
coarsest one's, whose input is the packed buffer. Elsewhere, and on the
concat route, the upsample, the pad and the conv stay PyTorch ops. Each
level's two 3x3 convs and their leaky relus go through `Conv.conv_leaky`,
on the card one kernel a conv (ops/conv3x3_pieces.py) where no gradient
is asked for: `conv_{i}_1` on its two pieces at once, on the packed route
packed from its gathered weights (`gathered`). The
packed route records nothing for autograd: a warp into a buffer carries
no gradient, the gathered weights are detached, and the upsampling kernel
has no backward.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
from torch import nn

from ..ops import conv_weights
from ..ops import resize
from ..ops import upconv2x2
from ..ops import warp
from ..options import Options
from .layers import Conv, conv_input

_NUMBER_OF_COLOR_CHANNELS = 3


def aligned_channels(feature_channels: int) -> int:
  """Channels of an aligned level: two warped (image, features) stacks
  plus two 2-channel flows."""
  return 2 * (_NUMBER_OF_COLOR_CHANNELS + feature_channels) + 4


class Layout(NamedTuple):
  """Where each part of a packed aligned level starts (channels)."""
  features0: int
  features1: int
  image0: int
  image1: int
  backward_flow: int
  forward_flow: int
  pad: int       # the first of the zero channels
  channels: int  # the buffer's


def packed_layout(feature_channels: int) -> Layout:
  """The packed layout of a level whose frames have `feature_channels`."""
  c, rgb = feature_channels, _NUMBER_OF_COLOR_CHANNELS
  image0 = 2 * c
  pad = image0 + 2 * rgb + 4
  return Layout(0, c, image0, image0 + rgb, image0 + 2 * rgb,
                image0 + 2 * rgb + 2, pad, -(-pad // 8) * 8)


def packed_order(feature_channels: int) -> Tuple[int, ...]:
  """For each channel of a packed level, its channel in the concat
  layout; -1 for the zeros."""
  c, rgb = feature_channels, _NUMBER_OF_COLOR_CHANNELS
  layout = packed_layout(c)
  # (packed start, concat start, width) of each part; the two flows keep
  # their place.
  parts = ((layout.features0, rgb, c), (layout.features1, 2 * rgb + c, c),
           (layout.image0, 0, rgb), (layout.image1, rgb + c, rgb),
           (layout.backward_flow, 2 * (rgb + c), 4))
  order = [-1] * layout.channels
  for packed, concat, width in parts:
    order[packed:packed + width] = range(concat, concat + width)
  return tuple(order)


def gathered(conv: Conv, order: Tuple[int, ...],
             pieces: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
  """`conv`'s weight for an input whose channel j is the layer's input
  channel `order[j]`, or feeds nothing where `order[j]` is -1 (a zero
  column), in the compute dtype, cut into contiguous weights of `pieces`
  input channels each, one a piece of the input (`Conv.conv`'s
  `weights`). Made once a weight, order, cut and dtype, and again after
  the weight is written to in place or moved (ops/conv_weights.derived);
  not differentiable."""
  if sum(pieces) != len(order):
    raise ValueError(f'pieces of {sum(pieces)} channels for an order of '
                     f'{len(order)}')
  return conv_weights.derived(
      conv.weight, ('gathered', order, pieces, conv.compute_dtype),
      lambda: _gather(conv, order, pieces))


def _gather(conv: Conv, order: Tuple[int, ...],
            pieces: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
  # Slices of the weight for each run of consecutive channels in `order`,
  # zeros for each run of -1: device operations only, so a capture may
  # make them too.
  weight = conv.weight.detach().to(conv.compute_dtype)
  columns, j = [], 0
  while j < len(order):
    start = j
    j += 1
    if order[start] < 0:
      while j < len(order) and order[j] < 0:
        j += 1
      columns.append(weight.new_zeros(
          (weight.shape[0], j - start) + weight.shape[2:]))
    else:
      while j < len(order) and order[j] == order[j - 1] + 1:
        j += 1
      columns.append(weight[:, order[start]:order[start] + j - start])
  full = torch.cat(columns, dim=1)
  return tuple(part.contiguous() for part in full.split(pieces, dim=1))


class Fusion(nn.Module):
  """The decoder. Input: the aligned feature pyramid, finest first."""

  def __init__(self, options: Options):
    super().__init__()
    self.levels = options.fusion_pyramid_levels
    self.split_convs = options.split_convs
    k, m = options.filters, options.specialized_levels
    dtype = options.compute_dtype

    def filters(i):
      return (k << i) if i < m else (k << m)

    # Each conv that reads an aligned level: its input channels in the
    # packed order, the aligned level's then the rest (upsampled
    # features) in their own order.
    self._packed_orders = {}
    for i in range(self.levels - 1):
      aligned = aligned_channels(options.feature_channels(i))
      coarsest = i == self.levels - 2
      coarser = (aligned_channels(options.feature_channels(i + 1))
                 if coarsest else filters(i + 1))
      self.add_module(f'conv_{i}_0', Conv(coarser, filters(i), 2, dtype))
      self.add_module(f'conv_{i}_1',
                      Conv(aligned + filters(i), filters(i), 3, dtype))
      self.add_module(f'conv_{i}_2', Conv(filters(i), filters(i), 3, dtype))
      self._packed_orders[f'conv_{i}_1'] = (
          packed_order(options.feature_channels(i)) +
          tuple(range(aligned, aligned + filters(i))))
      if coarsest:
        self._packed_orders[f'conv_{i}_0'] = packed_order(
            options.feature_channels(i + 1))
    self.output_conv = Conv(filters(0), _NUMBER_OF_COLOR_CHANNELS, 1,
                            torch.float32)

  def forward(self, pyramid: List[torch.Tensor]) -> torch.Tensor:
    """The decoder on an aligned pyramid in the concat layout."""
    return self._decode(pyramid, packed=False)

  def forward_in_place(self, image_pyramids: List[List[torch.Tensor]],
                       feature_pyramids: List[List[torch.Tensor]],
                       backward_flow: List[torch.Tensor],
                       forward_flow: List[torch.Tensor]):
    """The decoder on the aligned pyramid of two frames' (image, features)
    pyramids and the midpoint's flows, built in the packed layout
    (`align_in_place`); inference only. Returns the prediction and the
    two warped images at the finest level (views of its buffer)."""
    aligned = self.align_in_place(image_pyramids, feature_pyramids,
                                  backward_flow, forward_flow)
    layout = packed_layout(feature_pyramids[0][0].shape[-1])
    return (self._decode(aligned, packed=True),
            aligned[0][..., layout.image0:layout.image1],
            aligned[0][..., layout.image1:layout.backward_flow])

  @staticmethod
  def align_in_place(image_pyramids: List[List[torch.Tensor]],
                     feature_pyramids: List[List[torch.Tensor]],
                     backward_flow: List[torch.Tensor],
                     forward_flow: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The aligned pyramid in the packed layout, each level one buffer that
    the warps, the flows (cast to the buffer's dtype) and the pad's fill
    write in place."""
    aligned = []
    for image0, image1, features0, features1, flow0, flow1 in zip(
        *image_pyramids, *feature_pyramids, backward_flow, forward_flow):
      layout = packed_layout(features0.shape[-1])
      buffer = features0.new_empty(features0.shape[:3] + (layout.channels,))
      # Backward warping: the backward flow reads from frame 0, the forward
      # flow from frame 1.
      warp.backward_warp_into(features0, flow0, buffer, layout.features0)
      warp.backward_warp_into(features1, flow1, buffer, layout.features1)
      warp.backward_warp_into(image0, flow0, buffer, layout.image0)
      warp.backward_warp_into(image1, flow1, buffer, layout.image1)
      buffer[..., layout.backward_flow:layout.forward_flow] = flow0
      buffer[..., layout.forward_flow:layout.pad] = flow1
      buffer[..., layout.pad:].zero_()
      aligned.append(buffer)
    return aligned

  def _decode(self, pyramid: List[torch.Tensor],
              packed: bool) -> torch.Tensor:
    if len(pyramid) != self.levels:
      raise ValueError(
          'Fusion called with different number of pyramid levels '
          f'{len(pyramid)} than it was configured for, {self.levels}.')
    net = pyramid[-1]
    for i in reversed(range(self.levels - 1)):
      entry = pyramid[i]
      net = self._upsample_conv(f'conv_{i}_0', net,
                                (entry.shape[1], entry.shape[2]), packed)
      net = conv_input([entry, net], self.split_convs)
      net = self._conv(f'conv_{i}_1', net, packed, leaky=True)
      net = getattr(self, f'conv_{i}_2').conv_leaky(net)
    return self.output_conv(net.float())

  def _upsample_conv(self, name: str, x: torch.Tensor, size: Tuple[int, int],
                     packed: bool) -> torch.Tensor:
    # The 2x2 conv (no activation) of x's nearest upsample to `size`: on
    # the packed route one kernel where it takes the call (CUDA, a kernel
    # route for the dtype, channel counts it tiles; not the coarsest
    # level's gathered weights), else the library ops.
    conv = getattr(self, name)
    if packed and name not in self._packed_orders and upconv2x2.engages(
        x, conv.weight, conv.compute_dtype, size):
      return upconv2x2.upconv2x2_kernel(x, conv.weight, conv.bias)
    return self._conv(name, resize.resize_nearest(x, size), packed)

  def _conv(self, name: str, x, packed: bool,
            leaky: bool = False) -> torch.Tensor:
    # A conv that reads a packed aligned level takes its gathered weights;
    # with `leaky`, the conv and its leaky relu (Conv.conv_leaky).
    conv = getattr(self, name)
    weights = None
    if packed and name in self._packed_orders:
      pieces = [x] if isinstance(x, torch.Tensor) else x
      weights = gathered(conv, self._packed_orders[name],
                         tuple(p.shape[-1] for p in pieces))
    if leaky:
      return conv.conv_leaky(x, weights)
    return conv(x) if weights is None else conv.conv(x, weights)
