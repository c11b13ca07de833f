"""film_net in plain PyTorch: the benchmark's reference forward.

FILM (Reda et al., ECCV 2022; google-research/frame-interpolation,
models/film_net/*.py) written from the published description, NCHW, with
no kernel, cache, graph or batching trick:

  image pyramid (2x2 average pools) -> a cascaded feature pyramid (one
  sub-tree extractor of 3x3 conv + leaky relu pairs, shared by every level)
  -> coarse-to-fine residual flows in both directions (a shared predictor
  above `specialized_levels`) -> absolute flows, halved for the midpoint
  -> backward warps of (image, features) at the fusion levels -> a U-Net
  decoder (nearest x2, a 2x2 conv, a concat with the skip, two 3x3 convs)
  -> a 1x1 conv to RGB.

Parameters are a flat dict keyed by the names of the released checkpoint's
tree (`parameter_shapes`), weights (Cout, Cin, kh, kw). Every conv runs in
float32 with TF32 off unless `quant` is given: `quant(x)` then rounds each
conv's input and weight, and in the backward its cotangent (a lower
precision for the control, lowp.py), and the conv accumulates in
float32. The flows, the warp's coordinates, the last flow conv and the
output conv stay float32 in either case, as the configuration's
precision policy says.

Departures from the TF release: NCHW instead of NHWC and each concat conv
computed on the concat, which change nothing; and two ties of the
gradient taken as the port and its JAX reimplementation take them (leaky
relu's gradient 1 at exactly 0, the warp's fraction clip 0.5 at exactly
0 or 1), which training meets where rotated crops are zero-filled.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def feature_channels(o: dict, level: int) -> int:
  """Channels of the cascaded features at a pyramid level."""
  total = 0
  for j in range(o['sub_levels']):
    if j > level:
      break
    i = level - j
    if j < min(o['pyramid_levels'] - i, o['sub_levels']):
      total += o['filters'] << j
  return total


def parameter_shapes(o: dict) -> Dict[str, Tuple[int, ...]]:
  """Every weight and bias of the model, by name, in module order."""
  shapes: Dict[str, Tuple[int, ...]] = {}

  def conv(name, cin, cout, k):
    shapes[f'{name}.weight'] = (cout, cin, k, k)
    shapes[f'{name}.bias'] = (cout,)

  k = o['filters']
  for i in range(o['sub_levels']):
    cin = 3 if i == 0 else k << (i - 1)
    conv(f'feat_net.sub_extractor.cfeat_conv_{2 * i}', cin, k << i, 3)
    conv(f'feat_net.sub_extractor.cfeat_conv_{2 * i + 1}', k << i, k << i, 3)
  m = o['specialized_levels']
  predictors = [(f'flow_predictor_{i}', i) for i in range(m)]
  predictors.append(('flow_predictor_shared', m))
  for name, i in predictors:
    convs, filters = o['flow_convs'][i], o['flow_filters'][i]
    cin = 2 * feature_channels(o, i)
    for c in range(convs):
      conv(f'predict_flow.{name}.conv_{c}', cin, filters, 3)
      cin = filters
    conv(f'predict_flow.{name}.conv_{convs}', filters, filters // 2, 1)
    conv(f'predict_flow.{name}.conv_{convs + 1}', filters // 2, 2, 1)
  levels = o['fusion_pyramid_levels']

  def fusion_filters(i):
    return (k << i) if i < m else (k << m)

  def aligned(i):
    return 2 * (3 + feature_channels(o, i)) + 4

  for i in range(levels - 1):
    coarser = aligned(i + 1) if i == levels - 2 else fusion_filters(i + 1)
    conv(f'fusion.conv_{i}_0', coarser, fusion_filters(i), 2)
    conv(f'fusion.conv_{i}_1', aligned(i) + fusion_filters(i),
         fusion_filters(i), 3)
    conv(f'fusion.conv_{i}_2', fusion_filters(i), fusion_filters(i), 3)
  conv('fusion.output_conv', fusion_filters(0), 3, 1)
  return shapes


class QuantConv(torch.autograd.Function):
  """conv2d whose operands are rounded by `quant` first, forward and
  backward (the cotangent too), accumulating in float32: a conv run on a
  lower precision's tensor cores."""

  @staticmethod
  def forward(ctx, x, w, b, quant, padding):
    xq, wq = quant(x), quant(w)
    ctx.save_for_backward(xq, wq)
    ctx.quant, ctx.padding, ctx.has_bias = quant, padding, b is not None
    return F.conv2d(xq, wq, b, padding=padding)

  @staticmethod
  def backward(ctx, g):
    xq, wq = ctx.saved_tensors
    gq = ctx.quant(g)
    gx = gw = gb = None
    if ctx.needs_input_grad[0]:
      gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, padding=ctx.padding)
    if ctx.needs_input_grad[1]:
      gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, padding=ctx.padding)
    if ctx.has_bias and ctx.needs_input_grad[2]:
      gb = g.sum((0, 2, 3))
    return gx, gw, gb, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           padding: int, quant: Quant = None) -> torch.Tensor:
  if quant is None:
    return F.conv2d(x, w, b, padding=padding)
  return QuantConv.apply(x, w, b, quant, padding)


def conv(p: Params, name: str, x: torch.Tensor, quant: Quant = None,
         exact: bool = False) -> torch.Tensor:
  """TF 'SAME' conv of NCHW `x` (an even kernel pads one more after);
  `exact` keeps float32 whatever `quant` says."""
  w, b = p[f'{name}.weight'], p[f'{name}.bias']
  quant = None if exact else quant
  k = w.shape[-1]
  if k % 2 == 0:
    lo = (k - 1) // 2
    x = F.pad(x, (lo, k - 1 - lo, lo, k - 1 - lo))
    return conv2d(x, w, b, 0, quant)
  return conv2d(x, w, b, k // 2, quant)


class _LeakyRelu(torch.autograd.Function):
  """Leaky relu (slope 0.2) whose gradient at exactly 0 is 1, the rule of
  the JAX reimplementation that the port follows (TF's takes the slope
  there). It matters in training: zero-filled corners of rotated crops
  give convs exact zeros."""

  @staticmethod
  def forward(ctx, x):
    y = F.leaky_relu(x, 0.2)
    ctx.save_for_backward(x)
    return y

  @staticmethod
  def backward(ctx, grad):
    x, = ctx.saved_tensors
    return torch.where(x >= 0, grad, 0.2 * grad)


def lrelu(x: torch.Tensor) -> torch.Tensor:
  return _LeakyRelu.apply(x)


class _Clip01(torch.autograd.Function):
  """clip(t, 0, 1) whose gradient is 1 inside, 0.5 at exactly 0 or 1 and 0
  outside (jnp.clip's, which the port's warp follows): a flow of exactly
  0, as zero-filled regions give, puts the fraction at a tie."""

  @staticmethod
  def forward(ctx, t):
    ctx.save_for_backward(t)
    return t.clamp(0.0, 1.0)

  @staticmethod
  def backward(ctx, grad):
    t, = ctx.saved_tensors
    inside = ((t > 0) & (t < 1)).to(grad.dtype)
    edge = ((t == 0) | (t == 1)).to(grad.dtype)
    return grad * (inside + 0.5 * edge)


def upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """tf.image.resize bilinear (half-pixel centres, no antialias), NCHW."""

  def axis(t, dim, out):
    n = t.shape[dim]
    pos = (torch.arange(out, dtype=torch.float64, device=t.device) + 0.5) * (
        n / out) - 0.5
    lo = torch.floor(pos)
    frac = (pos - lo).to(torch.float32)
    lo_i = lo.long().clamp(0, n - 1)
    hi_i = (lo.long() + 1).clamp(0, n - 1)
    shape = [1] * t.dim()
    shape[dim] = out
    frac = frac.reshape(shape)
    return (t.index_select(dim, lo_i) * (1 - frac) +
            t.index_select(dim, hi_i) * frac)

  return axis(axis(x, 2, h), 3, w)


def upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """tf.image.resize nearest (half-pixel centres), NCHW."""

  def index(n, out):
    idx = torch.floor((torch.arange(out, dtype=torch.float64) + 0.5) *
                      (n / out)).long()
    return idx.clamp(0, n - 1).to(x.device)

  return x.index_select(2, index(x.shape[2], h)).index_select(
      3, index(x.shape[3], w))


def warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
  """Backward bilinear warp: out(y, x) = image(y + flow_y, x + flow_x).

  `image` (B, C, H, W) float32, `flow` (B, 2, H, W) as (dx, dy). The
  boundary rule of tfa's dense_image_warp: the floor of each coordinate is
  clamped into [0, size - 2] and its fraction into [0, 1]."""
  b, c, h, w = image.shape
  gy = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
  gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
  qy = gy + flow[:, 1]
  qx = gx + flow[:, 0]
  fy = torch.clamp(torch.floor(qy), 0.0, float(h - 2))
  fx = torch.clamp(torch.floor(qx), 0.0, float(w - 2))
  ay = _Clip01.apply(qy - fy)[:, None]
  ax = _Clip01.apply(qx - fx)[:, None]
  top = (fy.long() * w + fx.long()).reshape(b, 1, h * w)
  flat = image.reshape(b, c, h * w)

  def tap(offset):
    return flat.gather(2, (top + offset).expand(b, c, h * w)).reshape(
        b, c, h, w)

  t00, t01, t10, t11 = tap(0), tap(1), tap(w), tap(w + 1)
  return ((1 - ay) * ((1 - ax) * t00 + ax * t01) +
          ay * ((1 - ax) * t10 + ax * t11))


def image_pyramid(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
  out = [x]
  for _ in range(levels - 1):
    out.append(F.avg_pool2d(out[-1], 2))
  return out


def features(p: Params, o: dict, pyramid: Sequence[torch.Tensor],
             quant: Quant = None) -> List[torch.Tensor]:
  """The cascaded feature pyramid of one image pyramid."""
  levels, sub = len(pyramid), o['sub_levels']
  trees = []
  for i in range(levels):
    head, tree = pyramid[i], []
    n = min(levels - i, sub)
    for j in range(n):
      name = 'feat_net.sub_extractor.cfeat_conv_'
      head = lrelu(conv(p, f'{name}{2 * j}', head, quant))
      head = lrelu(conv(p, f'{name}{2 * j + 1}', head, quant))
      tree.append(head)
      if j < n - 1:
        head = F.avg_pool2d(head, 2)
    trees.append(tree)
  return [torch.cat([trees[i - j][j] for j in range(min(i + 1, sub))], 1)
          for i in range(levels)]


def _predict(p: Params, o: dict, level: int, a: torch.Tensor,
             b: torch.Tensor, quant: Quant) -> torch.Tensor:
  m = o['specialized_levels']
  i = min(level, m)
  name = (f'predict_flow.flow_predictor_{level}' if level < m else
          'predict_flow.flow_predictor_shared')
  convs = o['flow_convs'][i]
  net = torch.cat([a, b], 1)
  for c in range(convs + 1):
    net = lrelu(conv(p, f'{name}.conv_{c}', net, quant))
  return conv(p, f'{name}.conv_{convs + 1}', net, quant, exact=True)


def residual_flows(p: Params, o: dict, fa: Sequence[torch.Tensor],
                   fb: Sequence[torch.Tensor],
                   quant: Quant = None) -> List[torch.Tensor]:
  """Residual flows, finest first: B's features warped towards A."""
  levels = len(fa)
  v = _predict(p, o, levels - 1, fa[-1], fb[-1], quant)
  residuals = [v]
  for i in reversed(range(levels - 1)):
    v = upsample_bilinear(2.0 * v, fa[i].shape[2], fa[i].shape[3])
    res = _predict(p, o, i, fa[i], warp(fb[i], v), quant)
    residuals.append(res)
    v = res + v
  return list(reversed(residuals))


def flow_pyramid(residuals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  flow = residuals[-1]
  out = [flow]
  for res in reversed(list(residuals)[:-1]):
    flow = res + upsample_bilinear(2.0 * flow, res.shape[2], res.shape[3])
    out.append(flow)
  return list(reversed(out))


def fusion(p: Params, o: dict, aligned: Sequence[torch.Tensor],
           quant: Quant = None) -> torch.Tensor:
  net = aligned[-1]
  for i in reversed(range(o['fusion_pyramid_levels'] - 1)):
    skip = aligned[i]
    net = upsample_nearest(net, skip.shape[2], skip.shape[3])
    net = conv(p, f'fusion.conv_{i}_0', net, quant)
    net = torch.cat([skip, net], 1)
    net = lrelu(conv(p, f'fusion.conv_{i}_1', net, quant))
    net = lrelu(conv(p, f'fusion.conv_{i}_2', net, quant))
  return conv(p, 'fusion.output_conv', net, quant, exact=True)


Features = Tuple[List[torch.Tensor], List[torch.Tensor]]


def extract(p: Params, o: dict, x: torch.Tensor,
            quant: Quant = None) -> Features:
  """(image pyramid, feature pyramid) of NCHW frames in [0, 1]."""
  pyr = image_pyramid(x, o['pyramid_levels'])
  return pyr, features(p, o, pyr, quant)


def midpoint(p: Params, o: dict, f0: Features, f1: Features,
             quant: Quant = None) -> torch.Tensor:
  """The frame halfway between two frames, from their features."""
  levels = o['fusion_pyramid_levels']
  forward = flow_pyramid(residual_flows(p, o, f0[1], f1[1], quant))[:levels]
  backward = flow_pyramid(residual_flows(p, o, f1[1], f0[1], quant))[:levels]
  backward = [0.5 * f for f in backward]
  forward = [0.5 * f for f in forward]
  aligned = []
  for i in range(levels):
    from0 = warp(torch.cat([f0[0][i], f0[1][i]], 1), backward[i])
    from1 = warp(torch.cat([f1[0][i], f1[1][i]], 1), forward[i])
    aligned.append(torch.cat([from0, from1, backward[i], forward[i]], 1))
  return fusion(p, o, aligned, quant)


def forward(p: Params, o: dict, x0: torch.Tensor, x1: torch.Tensor,
            quant: Quant = None) -> torch.Tensor:
  """The model's image output for NCHW frames (sizes divisible by
  2^(pyramid_levels - 1))."""
  return midpoint(p, o, extract(p, o, x0, quant), extract(p, o, x1, quant),
                  quant)


def pad_to_align(x: torch.Tensor, align: int):
  """Centre zero-padding of NCHW `x` to multiples of `align`, and the crop
  (top, left, h, w) that undoes it."""
  h, w = x.shape[2], x.shape[3]
  ph, pw = (-h) % align, (-w) % align
  top, left = ph // 2, pw // 2
  return F.pad(x, (left, pw - left, top, ph - top)), (top, left, h, w)


def interpolate(p: Params, o: dict, x0: torch.Tensor, x1: torch.Tensor,
                align: int, quant: Quant = None) -> torch.Tensor:
  """Pad, forward, crop: the frame between NCHW frames of any size."""
  a, (top, left, h, w) = pad_to_align(x0, align)
  b, _ = pad_to_align(x1, align)
  return forward(p, o, a, b, quant)[:, :, top:top + h, left:left + w]
