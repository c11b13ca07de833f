"""The flow estimators' and the fusion's 3x3 convs in one kernel
(ops/conv3x3_pieces.py, csrc/conv3x3_pieces.cu).

On the CPU: which calls the kernel takes (`supported`, `eligible`) at
every conv of the released config: its 50 3x3 sites of a midpoint in bf16
and under TF32, and not the 1x1 convs, the extractor's convs, exact f32, a
forward under autograd or a row shard (the kernel stood in for by its
plain version); the plain version against the layer's own
`leaky_relu(Conv.conv(pieces))`, with the layer's weights and with the
fusion's gathered ones; the packed weights' zero columns against the
unpadded weight; `Conv.conv_leaky` on the CPU bit for bit the library
ops. The wrapper's arguments are checked in tests/test_torch_kernels_abi.py.

Marked `card` (skipped without a CUDA device; on the card, where JAX is
missing, run with `--noconftest`):

  python -m pytest --noconftest -p no:cacheprovider -m card \\
      tests/test_torch_conv_pieces.py

The kernel against its plain version at every distinct site shape of a
1080p midpoint in bf16 (within one bf16 ulp of the output's scale), in
TF32 at every distinct site of a UHD midpoint (against exact f32) and on
UHD slices that take each of those sites' tile plans (against f64 on
TF32-rounded operands and on the raw ones), at ragged extents; and the
`conv3x3_pieces` count of a midpoint: 50 in bf16 and TF32, 0 under
autograd, in exact f32 and in a row shard.
"""
import math
import types

import numpy as np
import pytest
import torch

from frame_interpolation_tpu_torch import parallel
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.models import film_net, fusion, layers
from frame_interpolation_tpu_torch.ops import _kernels, conv3x3_pieces
from frame_interpolation_tpu_torch.ops import conv_weights, rows
from frame_interpolation_tpu_torch.options import Options

torch.set_num_threads(2)

# 3x3 sites a midpoint of the released config: 2 directions x 7 levels x 3
# flow convs, and 4 fusion levels x 2.
MIDPOINT_SITES = 2 * 7 * 3 + 4 * 2


def _layer(cin, cout, dtype, seed=0, k=3):
  conv = layers.Conv(cin, cout, k, dtype)
  g = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    conv.weight.copy_(torch.randn(cout, cin, k, k, generator=g) *
                      (k * k * cin)**-0.5)
    conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
  return conv


def _pieces(channels, n=1, h=5, w=7, dtype=torch.float32, seed=1):
  g = torch.Generator().manual_seed(seed)
  return [(torch.rand(n, h, w, c, generator=g) * 2 - 1).to(dtype)
          for c in channels]


def _released_model(seed=0, **overrides):
  options = Options.film_net_released(**overrides)
  return film_net.init_params(film_net.create_model(options),
                              torch.Generator().manual_seed(seed))


def _frames(h=64, w=128, batch=1, seed=0):
  g = torch.Generator().manual_seed(seed)
  return (torch.rand(batch, h, w, 3, generator=g),
          torch.rand(batch, h, w, 3, generator=g),
          torch.full((batch, 1), 0.5))


@pytest.fixture
def routes(monkeypatch):
  """Each call the kernel route takes, as (piece channels, Cout), with the
  plain version standing in for the kernel on a device the test lets it
  engage on (`engages` is `eligible`)."""
  calls = []

  def kernel(pieces, weight, bias, weights=None, negative_slope=0.2):
    channels = [p.shape[-1] for p in pieces]
    calls.append((tuple(channels), weight.shape[0]))
    if weights is None:
      weights = weight.split(channels, dim=1)
    return conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, bias,
                                               negative_slope)

  monkeypatch.setattr(conv3x3_pieces, 'engages', conv3x3_pieces.eligible)
  monkeypatch.setattr(conv3x3_pieces, 'conv3x3_pieces_kernel', kernel)
  return calls


# ---- which calls the kernel takes -------------------------------------------


@pytest.mark.parametrize('channels,cout,dtype,tf32,want', [
    ((64, 64), 32, torch.bfloat16, False, True),     # flow, finest
    ((32,), 32, torch.bfloat16, False, True),
    ((960, 960), 256, torch.bfloat16, False, True),  # flow, shared
    ((144, 64), 64, torch.bfloat16, False, True),    # fusion conv_0_1
    ((1936, 512), 512, torch.float32, True, True),   # fusion conv_3_1, TF32
    ((144, 64), 64, torch.float32, False, False),    # exact f32
    ((144, 64), 64, torch.float64, True, False),
    ((64, 64, 64), 64, torch.bfloat16, False, False),  # three pieces
    ((64, 8), 64, torch.bfloat16, False, False),     # 8 channels
    ((64,), 16, torch.bfloat16, False, False),       # Cout 16
])
def test_supported_calls(monkeypatch, channels, cout, dtype, tf32, want):
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  pieces = [torch.zeros(1, 3, 4, c, dtype=dtype) for c in channels]
  weight = torch.zeros(cout, sum(channels), 3, 3)
  assert conv3x3_pieces.supported(pieces, weight, dtype) is want
  # Not a 1x1 conv, nor a conv in another dtype than the pieces'.
  assert not conv3x3_pieces.supported(pieces, weight[..., :1, :1], dtype)
  other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
  assert not conv3x3_pieces.supported(pieces, weight, other)
  # The CPU never engages.
  bias = torch.zeros(cout)
  assert not conv3x3_pieces.engages(pieces, weight, bias, dtype)


def test_eligible_refuses_gradients_row_shards_and_odd_layouts():
  conv = _layer(64, 64, torch.bfloat16)
  pieces = _pieces((48, 16), dtype=torch.bfloat16)

  def eligible(ps):
    return conv3x3_pieces.eligible(ps, conv.weight, conv.bias,
                                   torch.bfloat16)

  with torch.no_grad():
    assert eligible(pieces)
    # A strided piece, and one off a 16-byte boundary.
    strided = pieces[0].transpose(1, 2).contiguous().transpose(1, 2)
    assert not eligible([strided, pieces[1]])
    flat = torch.zeros(1 + pieces[0].numel(), dtype=torch.bfloat16)
    assert not eligible([flat[1:].view(pieces[0].shape), pieces[1]])
    # Inside a shard of a row-sharded forward (any shard installed).
    with rows.sharding(types.SimpleNamespace()):
      assert not eligible(pieces)
  # The layer's parameters ask for a gradient.
  assert not eligible(pieces)


@pytest.mark.parametrize('policy,tf32,grad,sites', [
    ('bfloat16', False, False, MIDPOINT_SITES),
    ('float32', True, False, MIDPOINT_SITES),
    ('float32', False, False, 0),   # exact f32
    ('bfloat16', False, True, 0),   # a forward under autograd
])
def test_a_midpoint_routes_its_50_3x3_sites(routes, monkeypatch, policy,
                                             tf32, grad, sites):
  # The released widths at 64x128 (all 7 levels): the flow estimators'
  # 3x3 convs in both directions and the fusion's conv_{i}_1 and
  # conv_{i}_2, never a 1x1 conv nor the extractor's. The prediction is
  # the library ops' (the kernel stood in for by its plain version).
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  model = _released_model(seed=4, dtype_policy=policy)
  x0, x1, t = _frames(seed=5)
  with torch.no_grad():
    monkeypatch.setattr(conv3x3_pieces, 'engages', lambda *a: False)
    want = model(x0, x1, t)['image']
    monkeypatch.setattr(conv3x3_pieces, 'engages', conv3x3_pieces.eligible)
  assert routes == []
  with torch.set_grad_enabled(grad):
    got = model(x0, x1, t)['image']
  assert len(routes) == sites
  if not sites:
    return
  flow = [(64, 64), (32,), (32,), (192, 192), (64,), (64,), (448, 448),
          (128,), (128,)] + [(960, 960), (256,), (256,)] * 4
  flow_cout = [32] * 3 + [64] * 3 + [128] * 3 + [256] * 12
  fused = [((1936, 512), 512), ((512,), 512), ((912, 256), 256),
           ((256,), 256), ((400, 128), 128), ((128,), 128),
           ((144, 64), 64), ((64,), 64)]
  # The flow runs coarse to fine in each direction.
  levels = [list(zip(flow[i:i + 3], flow_cout[i:i + 3]))
            for i in range(0, 21, 3)]
  one_direction = [s for level in reversed(levels) for s in level]
  assert routes == one_direction * 2 + fused
  bound = 1e-5 if policy == 'float32' else 2e-2
  assert float((got - want).abs().max()) <= bound * float(want.abs().max())


def test_a_row_sharded_forward_keeps_the_library_ops(routes):
  # Channel counts the kernel tiles at every 3x3 site (flow filters of 32,
  # fusion filters of 64): the whole frame takes the kernel at each, two
  # row shards at none.
  options = Options.tiny(filters=64, flow_filters=(32, 32, 32))
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(8))
  rng = np.random.RandomState(9)
  x0, x1 = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  state = model.state_dict()
  want = Interpolator(state, options, align=16, device='cpu')(x0, x1, dt)
  # 2 directions x 4 levels x 1 flow conv, 2 fusion levels x 2.
  assert len(routes) == 2 * 4 + 2 * 2
  routes.clear()
  got = parallel.SpatialShardedInterpolator(
      state, options, parallel.Mesh(['cpu'] * 2), align=16)(x0, x1, dt)
  assert routes == []
  assert float(np.abs(got - want).max()) <= 1e-5


def test_the_cpu_runs_the_library_ops_and_counts_nothing(monkeypatch):
  calls = []
  real = conv3x3_pieces.conv3x3_pieces_kernel
  monkeypatch.setattr(conv3x3_pieces, 'conv3x3_pieces_kernel',
                      lambda *a: calls.append(a) or real(*a))
  model = _released_model()
  x0, x1, t = _frames()
  _kernels.reset_launch_counts()
  with torch.no_grad():
    model(x0, x1, t)
  assert calls == []
  assert _kernels.launch_counts()['conv3x3_pieces'] == 0


# ---- the plain version, the packing and the library route ------------------


@pytest.mark.parametrize('channels,cout', [((64, 64), 32), ((48,), 64),
                                           ((40, 24), 96)])
@pytest.mark.parametrize('batch', [1, 2])
def test_plain_is_the_layer_with_leaky_relu(channels, cout, batch):
  # f32: the same sums in another order; f64: to rounding.
  for dtype, bound in ((torch.float32, 2e-6), (torch.float64, 1e-13)):
    conv = _layer(sum(channels), cout, dtype, seed=cout).to(dtype)
    pieces = _pieces(channels, n=batch, dtype=dtype, seed=batch)
    x = pieces if len(pieces) > 1 else pieces[0]
    with torch.no_grad():
      want = layers.leaky_relu(conv.conv(x))
      got = conv3x3_pieces.conv3x3_pieces_plain(
          pieces, conv.weight.split(list(channels), dim=1), conv.bias)
    assert got.shape == want.shape == (batch, 5, 7, cout)
    assert got.dtype == dtype
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= bound * scale


def test_plain_takes_the_gathered_weights_as_the_layer_does():
  # The fusion's conv_0_1 at the tiny widths on a packed level and the
  # upsampled net: the gathered weights, one a piece.
  model = film_net.create_model(Options.tiny(filters=16))
  film_net.init_params(model, torch.Generator().manual_seed(3))
  conv = model.fusion.conv_0_1
  order = model.fusion._packed_orders['conv_0_1']
  packed = fusion.packed_layout(model.options.feature_channels(0)).channels
  widths = (packed, len(order) - packed)
  pieces = _pieces(widths, h=6, w=9, seed=4)
  weights = fusion.gathered(conv, order, widths)
  with torch.no_grad():
    want = layers.leaky_relu(conv.conv(pieces, weights))
    got = conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, conv.bias)
  assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def test_plain_rounds_once_to_the_pieces_dtype():
  conv = _layer(80, 64, torch.bfloat16, seed=2)
  pieces = _pieces((64, 16), dtype=torch.bfloat16, seed=3)
  weights = conv.weight.split([64, 16], dim=1)
  with torch.no_grad():
    got = conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, conv.bias)
    exact = conv3x3_pieces.conv3x3_pieces_plain(
        [p.double() for p in pieces],
        [w.bfloat16().double() for w in weights],
        conv.bias.bfloat16().double())
  assert got.dtype == torch.bfloat16
  ulp = 2.0**(math.floor(math.log2(float(exact.abs().max()))) - 7)
  assert float((got.double() - exact).abs().max()) <= ulp


@pytest.mark.parametrize('dtype,route', [(torch.bfloat16, 'bf16'),
                                         (torch.float32, 'tf32'),
                                         (torch.float32, 'f32')])
@pytest.mark.parametrize('channels', [(144, 64), (32,), (400, 128),
                                      (16, 48)])
def test_the_zero_column_tail_packing_gives_the_unpadded_sums(dtype, route,
                                                              channels):
  cout = 32
  conv = _layer(sum(channels), cout, torch.float32, seed=len(channels))
  weights = conv.weight.split(list(channels), dim=1)
  chunk = conv3x3_pieces.CHUNK_CHANNELS[dtype]
  packed = conv_weights.packed_pieces(conv.weight, channels, dtype, route,
                                      chunk)
  padded = [-(-c // chunk) * chunk for c in channels]
  assert packed.dtype == dtype and packed.is_contiguous()
  assert tuple(packed.shape) == (cout, 9 * sum(padded))
  pieces = _pieces(channels, h=6, w=9, dtype=torch.float64, seed=7)
  col, taps, zero_padded = 0, [], []
  for weight, piece, c, cpad in zip(weights, pieces, channels, padded):
    part = packed[:, col:col + 9 * cpad].reshape(cout, 3, 3, cpad)
    col += 9 * cpad
    # Tap major, channel minor; zeros past the piece's channels.
    want = weight.detach().to(dtype).permute(0, 2, 3, 1)
    if route == 'tf32':
      want = conv_weights.round_tf32(want)
    assert torch.equal(part[..., :c], want)
    assert not part[..., c:].any()
    taps.append(part.permute(0, 3, 1, 2).double())
    zero_padded.append(torch.nn.functional.pad(piece, (0, cpad - c)))
  # The padded weights on the zero-padded pieces (as the kernel reads them)
  # and the unpadded weights on the pieces: the same sums.
  bias = torch.zeros(cout, dtype=torch.float64)
  got = conv3x3_pieces.conv3x3_pieces_plain(zero_padded, taps, bias)
  want = conv3x3_pieces.conv3x3_pieces_plain(
      pieces, [t[:, :c] for t, c in zip(taps, channels)], bias)
  assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def _packed(weight, channels, weights=None):
  return conv_weights.packed_pieces(weight, channels, torch.bfloat16, 'bf16',
                                    64, weights)


def test_packed_weights_are_kept_per_use_and_follow_the_weight():
  conv = _layer(80, 32, torch.bfloat16)
  first = _packed(conv.weight, (64, 16))
  assert _packed(conv.weight, (64, 16)) is first
  # Another cut of the input channels is another copy.
  other = _packed(conv.weight, (16, 64))
  assert other is not first and other.shape == (32, 9 * 128)
  with torch.no_grad():
    conv.weight.mul_(2)
  again = _packed(conv.weight, (64, 16))
  assert torch.equal(again.float(), 2 * first.float())
  with pytest.raises(ValueError, match='pieces of 96 channels'):
    _packed(conv.weight, (64, 32))


def test_gathered_weights_pack_once_under_inference_mode():
  # The fusion's conv_0_1 on its packed route, as the interpolator runs it:
  # the packed copy is derived from the gathered copy, both kept across
  # calls, and both made again once the weight changes.
  model = film_net.create_model(Options.tiny(filters=16))
  film_net.init_params(model, torch.Generator().manual_seed(6))
  conv = model.fusion.conv_0_1
  order = model.fusion._packed_orders['conv_0_1']
  packed = fusion.packed_layout(model.options.feature_channels(0)).channels
  widths = (packed, len(order) - packed)

  def pack():
    weights = fusion.gathered(conv, order, widths)
    return weights, _packed(conv.weight, widths, weights)

  with torch.inference_mode():
    weights, first = pack()
    again_weights, again = pack()
  assert again_weights is weights and again is first
  assert not first.is_inference() and not weights[0].is_inference()
  want = conv_weights._pack(weights, torch.bfloat16, 'bf16', 64).flatten(1)
  assert torch.equal(first, want)
  with torch.no_grad():
    conv.weight.mul_(2)
  with torch.inference_mode():
    weights, changed = pack()
  assert changed is not first
  assert torch.equal(changed.float(), 2 * first.float())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('channels', [(64, 64), (48,)])
def test_conv_leaky_on_the_cpu_is_the_library_ops_bit_for_bit(dtype,
                                                             channels):
  conv = _layer(sum(channels), 64, dtype, seed=5)
  pieces = _pieces(channels, n=2, dtype=dtype, seed=6)
  x = pieces if len(pieces) > 1 else pieces[0]
  with torch.no_grad():
    assert torch.equal(conv.conv_leaky(x), layers.leaky_relu(conv(x)))
  # And under autograd, with the layer's gradient.
  got = conv.conv_leaky(x)
  got.sum().backward()
  grad = conv.weight.grad.clone()
  conv.weight.grad = None
  want = layers.leaky_relu(conv(x))
  want.sum().backward()
  assert torch.equal(got, want) and torch.equal(grad, conv.weight.grad)


def test_conv_leaky_with_gathered_weights_is_the_fusion_library_route():
  model = film_net.create_model(Options.tiny(filters=16))
  film_net.init_params(model, torch.Generator().manual_seed(2))
  conv = model.fusion.conv_0_1
  order = model.fusion._packed_orders['conv_0_1']
  packed = fusion.packed_layout(model.options.feature_channels(0)).channels
  widths = (packed, len(order) - packed)
  pieces = _pieces(widths, h=6, w=9, seed=3)
  with torch.no_grad():
    got = conv.conv_leaky(pieces, fusion.gathered(conv, order, widths))
    want = layers.leaky_relu(conv.conv(pieces,
                                       fusion.gathered(conv, order, widths)))
  assert torch.equal(got, want)


# ---- on the card ------------------------------------------------------------

# (N, H, W, piece channels, Cout) of every distinct 3x3 site of a 1080p
# midpoint (the frame padded to 1088x1920): the flow estimators' levels 0-6
# and the fusion's levels 0-3.
SITES_1080P = [
    (1, 1088, 1920, (64, 64), 32), (1, 1088, 1920, (32,), 32),
    (1, 544, 960, (192, 192), 64), (1, 544, 960, (64,), 64),
    (1, 272, 480, (448, 448), 128), (1, 272, 480, (128,), 128),
    (1, 136, 240, (960, 960), 256), (1, 136, 240, (256,), 256),
    (1, 68, 120, (960, 960), 256), (1, 68, 120, (256,), 256),
    (1, 34, 60, (960, 960), 256), (1, 34, 60, (256,), 256),
    (1, 17, 30, (960, 960), 256), (1, 17, 30, (256,), 256),
    (1, 1088, 1920, (144, 64), 64), (1, 1088, 1920, (64,), 64),
    (1, 544, 960, (400, 128), 128), (1, 544, 960, (128,), 128),
    (1, 272, 480, (912, 256), 256), (1, 272, 480, (256,), 256),
    (1, 136, 240, (1936, 512), 512), (1, 136, 240, (512,), 512)]
# The same of a UHD midpoint (2160x3840 padded to 2176x3840), as
# pair-4k-f32 runs them in TF32: every level twice as tall and wide.
SITES_UHD = [(n, 2 * h, 2 * w, channels, cout)
             for n, h, w, channels, cout in SITES_1080P]
# TF32 on UHD slices (the f64 references of whole UHD levels take
# minutes), one for each tile plan the UHD sites take (8 rows of N = 32
# and 64, 4 rows of 128, 2 rows of 256, 128 and 64).
SITES_TF32 = [(1, 256, 512, (64, 64), 32), (1, 256, 512, (32,), 32),
              (1, 256, 512, (144, 64), 64), (1, 64, 512, (448, 448), 128),
              (1, 64, 512, (400, 128), 128), (1, 32, 512, (960, 960), 256),
              (1, 32, 512, (912, 256), 256), (1, 16, 512, (1936, 512), 512),
              (1, 68, 120, (960, 960), 256), (1, 34, 60, (960, 960), 256),
              (1, 34, 60, (1936, 512), 512)]
# Ragged extents, batches, and K tails of 48 and 16 channels.
SITES_RAGGED = [(2, 37, 45, (112, 16), 32), (2, 37, 45, (144, 64), 64),
                (2, 19, 131, (400, 128), 128), (3, 9, 70, (48,), 64)]
# As tests/test_torch_upconv2x2.py bounds the TF32 route: relative RMS to
# f64 on the raw operands, and to f64 on the rounded ones 5e-9 a term of
# K = 9 Cin (the f32 sums' drift).
RAW_RMS_BOUND = 3.5e-4
ROUNDED_RMS_BOUND_PER_K = 5e-9


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card; see the docstring)')
  _kernels.library()
  return torch.device('cuda')


def _site(site, dtype, device, seed=0):
  n, h, w, channels, cout = site
  conv = _layer(sum(channels), cout, dtype, seed=h + cout + seed).to(device)
  pieces = [p.to(device) for p in _pieces(channels, n=n, h=h, w=w,
                                          dtype=dtype, seed=w + seed)]
  return pieces, conv


def _rel_rms(got, want):
  diff = got.double() - want
  return float((diff.square().sum() / want.square().sum()).sqrt())


@pytest.mark.card
@pytest.mark.parametrize('site', SITES_1080P + SITES_RAGGED)
def test_bf16_kernel_is_within_one_ulp_of_the_plain_sums(card, site):
  pieces, conv = _site(site, torch.bfloat16, card)
  weights = conv.weight.split(list(site[3]), dim=1)
  with torch.no_grad():
    got = conv3x3_pieces.conv3x3_pieces_kernel(pieces, conv.weight,
                                               conv.bias)
    with torch.backends.cudnn.flags(allow_tf32=False):
      plain = conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, conv.bias)
  torch.cuda.synchronize()
  ulp = 2.0**(math.floor(math.log2(float(plain.float().abs().max()))) - 7)
  assert float((got.float() - plain.float()).abs().max()) <= ulp


@pytest.mark.card
@pytest.mark.parametrize('site', SITES_TF32 + SITES_RAGGED)
def test_tf32_kernel_rounds_its_operands(card, site):
  pieces, conv = _site(site, torch.float32, card)
  with torch.backends.cudnn.flags(allow_tf32=True), torch.no_grad():
    got = conv3x3_pieces.conv3x3_pieces_kernel(pieces, conv.weight,
                                               conv.bias)
  torch.cuda.synchronize()
  weights = conv.weight.detach().split(list(site[3]), dim=1)
  bias = conv.bias.detach().double()
  with torch.backends.cudnn.flags(allow_tf32=False):
    raw = conv3x3_pieces.conv3x3_pieces_plain(
        [p.double() for p in pieces], [w.double() for w in weights], bias)
    rounded = conv3x3_pieces.conv3x3_pieces_plain(
        [conv_weights.round_tf32(p).double() for p in pieces],
        [conv_weights.round_tf32(w.contiguous()).double() for w in weights],
        bias)
  assert _rel_rms(got, raw) <= RAW_RMS_BOUND
  assert _rel_rms(got, rounded) <= (ROUNDED_RMS_BOUND_PER_K * 9 *
                                    sum(site[3]))


@pytest.mark.card
@pytest.mark.parametrize('site', SITES_UHD)
def test_tf32_kernel_at_the_uhd_sites_is_near_exact_f32(card, site):
  # Whole UHD levels, against the plain sums in exact f32 on the card.
  n, h, w, channels, cout = site
  conv = _layer(sum(channels), cout, torch.float32, seed=h + cout).to(card)
  g = torch.Generator(device=card).manual_seed(w)
  pieces = [torch.rand(n, h, w, c, generator=g, device=card) * 2 - 1
            for c in channels]
  with torch.no_grad():
    with torch.backends.cudnn.flags(allow_tf32=True):
      got = conv3x3_pieces.conv3x3_pieces_kernel(pieces, conv.weight,
                                                 conv.bias)
    with torch.backends.cudnn.flags(allow_tf32=False):
      exact = conv3x3_pieces.conv3x3_pieces_plain(
          pieces, conv.weight.split(list(channels), dim=1), conv.bias)
    assert _rel_rms(got, exact.double()) <= RAW_RMS_BOUND


@pytest.mark.card
def test_the_tf32_slices_take_every_plan_of_the_uhd_sites(card):
  def plans(sites):
    return {conv3x3_pieces.tile_plan(n, h, w, cout)
            for n, h, w, _, cout in sites}

  assert plans(SITES_UHD) <= plans(SITES_TF32)


@pytest.mark.card
@pytest.mark.parametrize('policy,tf32,grad,launches', [
    ('bfloat16', False, False, MIDPOINT_SITES),
    ('bfloat16', False, True, 0),
    ('float32', True, False, MIDPOINT_SITES),
    ('float32', False, False, 0)])
def test_a_midpoint_counts_50_pieces_launches(card, policy, tf32, grad,
                                              launches):
  model = _released_model(dtype_policy=policy).to(card)
  g = torch.Generator().manual_seed(3)
  x0, x1 = (torch.rand(1, 128, 192, 3, generator=g).to(card)
            for _ in range(2))
  _kernels.reset_launch_counts()
  with torch.backends.cudnn.flags(allow_tf32=tf32), (
      torch.set_grad_enabled(grad)):
    model(x0, x1, torch.full((1, 1), 0.5, device=card))
  assert _kernels.launch_counts()['conv3x3_pieces'] == launches


@pytest.mark.card
def test_a_row_sharded_pair_counts_no_pieces_launches(card):
  options = Options.film_net_released(dtype_policy='bfloat16')
  state = _released_model(dtype_policy='bfloat16').state_dict()
  rng = np.random.RandomState(1)
  x0, x1 = (rng.rand(1, 256, 384, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  _kernels.reset_launch_counts()
  parallel.SpatialShardedInterpolator(state, options,
                                      parallel.Mesh([card] * 2), align=64,
                                      graphs=False)(x0, x1, dt)
  assert _kernels.launch_counts()['conv3x3_pieces'] == 0
