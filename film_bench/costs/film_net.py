"""Operations and compulsory bytes of film_net's work, from shapes alone.

FLOPs count 2 per multiply-add of every conv (k x k x Cin x Cout per
output pixel) and of every Gram product; elementwise work, pools, warps
and resizes are left out (under 0.5% of a pair). Bytes are those a kernel
has to move once: each input read once, each output written once.

`options` is the configuration's model block (Options' fields); H and W
are the padded frame's, divisible by 2^(pyramid_levels - 1).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

from . import peaks


def feature_channels(o: dict, level: int) -> int:
  total = 0
  for j in range(o['sub_levels']):
    if j > level:
      break
    i = level - j
    if j < min(o['pyramid_levels'] - i, o['sub_levels']):
      total += o['filters'] << j
  return total


class Conv(NamedTuple):
  pixels: int  # output pixels (batch included)
  cin: int
  cout: int
  k: int
  image_input: bool = False  # reads the frame itself (no data gradient)

  @property
  def flops(self) -> float:
    return 2.0 * self.pixels * self.k * self.k * self.cin * self.cout


class ConvSite(NamedTuple):
  """A conv3x3 + bias + leaky relu (+ 2x2 pool) of the port's conv kernel."""
  n: int
  h: int
  w: int
  cin: int
  cout: int
  pool: bool


def extraction_convs(o: dict, n: int, h: int, w: int) -> List[Conv]:
  """The convs of one frame's feature pyramid, `n` frames a batch."""
  out, f = [], o['filters']
  levels = o['pyramid_levels']
  for i in range(levels):
    for j in range(min(levels - i, o['sub_levels'])):
      px = n * (h >> (i + j)) * (w >> (i + j))
      cin = 3 if j == 0 else f << (j - 1)
      out.append(Conv(px, cin, f << j, 3, image_input=(j == 0)))
      out.append(Conv(px, f << j, f << j, 3))
  return out


def conv_sites(o: dict, n: int, h: int, w: int) -> List[ConvSite]:
  """The extractor's convs that run the port's conv kernel, for one frame:
  the second conv of every sub-level and the first from sub-level 2 on,
  each pooled where a next sub-level follows."""
  out, f = [], o['filters']
  levels = o['pyramid_levels']
  for i in range(levels):
    depth = min(levels - i, o['sub_levels'])
    for j in range(depth):
      hh, ww, pool = h >> (i + j), w >> (i + j), j < depth - 1
      if j >= 2:
        out.append(ConvSite(n, hh, ww, f << (j - 1), f << j, False))
      out.append(ConvSite(n, hh, ww, f << j, f << j, pool))
  return out


def midpoint_convs(o: dict, n: int, h: int, w: int) -> List[Conv]:
  """The convs of the two flow estimations and the fusion."""
  out = []
  levels, m = o['pyramid_levels'], o['specialized_levels']
  for _ in range(2):
    for i in range(levels):
      px = n * (h >> i) * (w >> i)
      p = min(i, m)
      filters = o['flow_filters'][p]
      cin = 2 * feature_channels(o, i)
      for _ in range(o['flow_convs'][p]):
        out.append(Conv(px, cin, filters, 3))
        cin = filters
      out.append(Conv(px, filters, filters // 2, 1))
      out.append(Conv(px, filters // 2, 2, 1))
  f, fl = o['filters'], o['fusion_pyramid_levels']

  def filters_at(i):
    return (f << i) if i < m else (f << m)

  def aligned(i):
    return 2 * (3 + feature_channels(o, i)) + 4

  for i in range(fl - 1):
    px = n * (h >> i) * (w >> i)
    coarser = aligned(i + 1) if i == fl - 2 else filters_at(i + 1)
    out.append(Conv(px, coarser, filters_at(i), 2))
    out.append(Conv(px, aligned(i) + filters_at(i), filters_at(i), 3))
    out.append(Conv(px, filters_at(i), filters_at(i), 3))
  out.append(Conv(n * h * w, filters_at(0), 3, 1))
  return out


def flops(convs: List[Conv]) -> float:
  return sum(c.flops for c in convs)


def pair_flops(o: dict, n: int, h: int, w: int) -> float:
  """One forward on a pair: two extractions and a midpoint."""
  return 2 * flops(extraction_convs(o, n, h, w)) + flops(
      midpoint_convs(o, n, h, w))


def tree_flops_per_new_frame(o: dict, h: int, w: int, inputs: int,
                             times: int) -> float:
  """The feature-cached tree over a clip: every new frame a midpoint, and
  an extraction of every input frame and of every new frame that is not a
  leaf (its features feed the next depth), per new frame."""
  pairs = inputs - 1
  new = pairs * (2**times - 1)
  extractions = inputs + pairs * (2**(times - 1) - 1)
  total = (new * flops(midpoint_convs(o, 1, h, w)) +
           extractions * flops(extraction_convs(o, 1, h, w)))
  return total / new


def conv_site_cost(site: ConvSite, element_size: int) -> Tuple[float, float]:
  """FLOPs and compulsory bytes of one site: x and the weights read in
  x's dtype, the f32 bias, y and the pool written in x's dtype."""
  pixels = site.n * site.h * site.w
  flops_ = 2.0 * pixels * 9 * site.cin * site.cout
  nbytes = (pixels * (site.cin + site.cout) * element_size +
            9 * site.cin * site.cout * element_size + site.cout * 4 +
            (pixels // 4 * site.cout * element_size if site.pool else 0))
  return flops_, nbytes


def conv_bound_ms(o: dict, n: int, h: int, w: int, frames: int,
                  precision: str) -> float:
  """The summed roofline bound of the conv kernel's sites over `frames`
  extractions of n x h x w."""
  size = 2 if precision == 'bfloat16' else 4
  peak = peaks.PEAK_FLOPS[precision]
  return frames * sum(peaks.bound_ms(*conv_site_cost(s, size), peak)
                      for s in conv_sites(o, n, h, w))


def warp_sites(o: dict, n: int, h: int, w: int) -> List[Tuple[int, ...]]:
  """(n, h, w, C) of every warp of a forward: the flow estimator's at each
  level but the coarsest, and the fusion levels' (image, features) stacks,
  both directions each."""
  levels = o['pyramid_levels']
  out = []
  for _ in range(2):
    out += [(n, h >> i, w >> i, feature_channels(o, i))
            for i in range(levels - 1)]
    out += [(n, h >> i, w >> i, 3 + feature_channels(o, i))
            for i in range(o['fusion_pyramid_levels'])]
  return out


def splat_bound_ms(o: dict, n: int, h: int, w: int) -> float:
  """The summed roofline bound of a train step's splats (the warp's image
  gradient, f32): the cotangent read, the f32 gradient written once, the
  flow read. Bytes bind: 8 FLOPs an element against 12 bytes."""
  total = 0.0
  for b, hh, ww, c in warp_sites(o, n, h, w):
    elements = b * hh * ww * c
    total += peaks.bound_ms(8.0 * elements, elements * 8 + b * hh * ww * 2 * 4,
                            peaks.PEAK_FLOPS['float32'])
  return total


def vgg_flops(n: int, h: int, w: int, channels) -> Tuple[float, List]:
  """FLOPs of one VGG-19 tower to conv5_2, and each conv5-style layer's
  (c, h, w) for the Gram products."""
  total, cin, hh, ww = 0.0, 3, h, w
  layers = []
  names = ('conv1_1', 'conv1_2', 'conv2_1', 'conv2_2', 'conv3_1', 'conv3_2',
           'conv3_3', 'conv3_4', 'conv4_1', 'conv4_2', 'conv4_3', 'conv4_4',
           'conv5_1', 'conv5_2')
  for name, cout in zip(names, channels):
    total += 2.0 * n * hh * ww * 9 * cin * cout
    layers.append((name, cout, hh, ww))
    cin = cout
    if name in ('conv1_2', 'conv2_2', 'conv3_4', 'conv4_4'):
      hh, ww = -(-hh // 2), -(-ww // 2)
  return total, layers


def train_step_flops(o: dict, n: int, h: int, w: int,
                     vgg_channels) -> Dict[str, float]:
  """A film_net-Style step: the model's forward and backward (the
  gradient of every weight, and of every input but the frames), VGG-19's
  two towers forward and the prediction's tower backward (the data
  gradient alone: its weights are constants), and the Gram products of
  both towers forward and of the prediction's backward (two products)."""
  convs = (extraction_convs(o, n, h, w) * 2) + midpoint_convs(o, n, h, w)
  forward = flops(convs)
  backward = sum(c.flops * (1 if c.image_input else 2) for c in convs)
  tower, layers = vgg_flops(n, h, w, vgg_channels)
  loss_layers = ('conv1_2', 'conv2_2', 'conv3_2', 'conv4_2', 'conv5_2')
  gram = sum(2.0 * n * c * c * hh * ww for name, c, hh, ww in layers
             if name in loss_layers)
  return {'film_net': forward + backward, 'vgg': 3 * tower,
          'gram': 4 * gram}
