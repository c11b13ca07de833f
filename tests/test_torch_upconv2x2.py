"""The fusion decoder's upsampling conv in one kernel (ops/upconv2x2.py,
csrc/upconv2x2.cu).

On the CPU: the plain phase arithmetic equals the layer's `conv_{i}_0` on
`resize_nearest` of its input, in f64, at the three released levels'
channel counts, batch 1 and 2, the padded last row and column included;
which calls the kernel takes (`supported`); and the route `Fusion._decode`
takes: the library ops on the CPU, under autograd, under a row shard and
in exact f32, the kernel at the three finer levels of the packed route
where a device has it (stood in for here by the plain phases). The
wrapper's arguments are checked in tests/test_torch_kernels_abi.py.

Marked `card` (skipped without a CUDA device; on the card, where JAX is
missing, run with `--noconftest`):

  python -m pytest --noconftest -p no:cacheprovider -m card \\
      tests/test_torch_upconv2x2.py

The kernel against the plain phases and against the library path it
replaces (resize_nearest, the layer's pad and cuDNN's conv) at the 1080p
sites and one UHD site: bf16 within one bf16 ulp of the output's scale;
TF32 against f64 on TF32-rounded operands (the f32 sums alone) and on the
raw ones. And the `upconv2x2` count of a midpoint: 3 on the packed route,
0 under autograd and in exact f32.
"""
import math
import types

import numpy as np
import pytest
import torch

from frame_interpolation_tpu_torch import parallel
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.models import film_net, fusion, layers
from frame_interpolation_tpu_torch.ops import _kernels, conv_weights, resize
from frame_interpolation_tpu_torch.ops import upconv2x2
from frame_interpolation_tpu_torch.options import Options

torch.set_num_threads(2)

# (Cin, Cout) of conv_0_0, conv_1_0 and conv_2_0 at the released widths.
LEVELS = [(128, 64), (256, 128), (512, 256)]


def _layer(cin, cout, dtype, seed=0, device='cpu'):
  conv = layers.Conv(cin, cout, 2, dtype)
  g = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    conv.weight.copy_(torch.randn(cout, cin, 2, 2, generator=g) *
                      (4.0 * cin)**-0.5)
    conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
  return conv.to(device)


def _coarse(n, h, w, c, seed=1, device='cpu'):
  g = torch.Generator().manual_seed(seed)
  return (torch.rand(n, h, w, c, generator=g) * 2 - 1).to(device)


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('cin,cout', LEVELS)
def test_plain_phases_are_the_layer_on_the_nearest_upsample(cin, cout,
                                                            batch):
  conv = _layer(cin, cout, torch.float64)
  x = _coarse(batch, 5, 7, cin).double()
  with torch.no_grad():
    want = conv(resize.resize_nearest(x, (10, 14)))
    got = upconv2x2.upconv2x2_plain(x, conv.weight, conv.bias)
  assert got.shape == want.shape == (batch, 10, 14, cout)
  assert got.dtype == torch.float64
  scale = float(want.abs().max())
  assert float((got - want).abs().max()) <= 1e-12 * scale
  # The padding: the last row and column see zeros below and right. With
  # the edge repeated instead, only they would change.
  edge = torch.cat([x, x[:, -1:]], dim=1)
  edge = torch.cat([edge, edge[:, :, -1:]], dim=2)
  with torch.no_grad():
    edge_out = upconv2x2.upconv2x2_plain(edge, conv.weight, conv.bias)
  assert torch.allclose(edge_out[:, :9, :13], got[:, :-1, :-1], rtol=0,
                        atol=1e-12 * scale)
  assert float((edge_out[:, 9, :14] - got[:, -1]).abs().max()) > 1e-3 * scale
  assert float((edge_out[:, :10, 13] - got[:, :, -1]).abs().max()) > (
      1e-3 * scale)


def test_plain_phases_round_once_to_the_input_dtype():
  conv = _layer(128, 64, torch.bfloat16, seed=2)
  x = _coarse(1, 4, 6, 128, seed=3).bfloat16()
  with torch.no_grad():
    got = upconv2x2.upconv2x2_plain(x, conv.weight, conv.bias)
  # f64 sums of the same bf16 values, the bias in bf16's value: one
  # rounding of nearly the same number.
  with torch.no_grad():
    exact = upconv2x2.upconv2x2_plain(x.double(),
                                      conv.weight.bfloat16().double(),
                                      conv.bias.bfloat16().double())
  assert got.dtype == torch.bfloat16
  ulp = 2.0**(math.floor(math.log2(float(exact.abs().max()))) - 7)
  assert float((got.double() - exact).abs().max()) <= ulp


@pytest.mark.parametrize('dtype,tf32,size,channels,want', [
    (torch.bfloat16, False, (8, 12), (128, 64), True),
    (torch.float32, True, (8, 12), (256, 128), True),
    (torch.float32, False, (8, 12), (128, 64), False),   # exact f32
    (torch.float64, True, (8, 12), (128, 64), False),
    (torch.bfloat16, False, (8, 11), (128, 64), False),  # not an exact x2
    (torch.bfloat16, False, (7, 12), (128, 64), False),
    (torch.bfloat16, False, (8, 12), (1936, 960), False),  # the coarsest
    (torch.bfloat16, False, (8, 12), (128, 32), False),
])
def test_supported_calls(monkeypatch, dtype, tf32, size, channels, want):
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  cin, cout = channels
  x = torch.zeros(1, 4, 6, cin, dtype=dtype)
  weight = torch.zeros(cout, cin, 2, 2)
  assert upconv2x2.supported(x, weight, dtype, size) is want
  # The CPU never engages.
  assert not upconv2x2.engages(x, weight, dtype, size)
  # Nor a conv in another dtype than x's.
  other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
  assert not upconv2x2.supported(x, weight, other, size)


def test_the_wrapper_refuses_what_it_has_no_route_for(monkeypatch):
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
  conv = _layer(128, 64, torch.float32)
  with pytest.raises(ValueError, match='TF32'):
    upconv2x2.upconv2x2_kernel(torch.zeros(1, 2, 2, 128), conv.weight,
                               conv.bias)
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
  with pytest.raises(ValueError, match='CUDA'):
    upconv2x2.upconv2x2_kernel(torch.zeros(1, 2, 2, 128), conv.weight,
                               conv.bias)
  with pytest.raises(ValueError, match=r'weight \(Cout, 128, 2, 2\)'):
    upconv2x2.upconv2x2_plain(torch.zeros(1, 2, 2, 128),
                              torch.zeros(64, 128, 3, 3), conv.bias)


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
  """Counts each route of the decoder's upsampling step: 'kernel' for
  `upconv2x2_kernel` (here the plain phases, on a device the test lets
  the kernel engage on: `engages` is `supported`), 'library' for
  `resize_nearest` as models/fusion.py calls it."""
  calls = {'kernel': 0, 'library': 0}

  def kernel(x, weight, bias):
    calls['kernel'] += 1
    return upconv2x2.upconv2x2_plain(x, weight, bias)

  def library(x, size):
    calls['library'] += 1
    return resize.resize_nearest(x, size)

  monkeypatch.setattr(upconv2x2, 'engages', upconv2x2.supported)
  monkeypatch.setattr(upconv2x2, 'upconv2x2_kernel', kernel)
  monkeypatch.setattr(fusion, 'resize',
                      types.SimpleNamespace(resize_nearest=library))
  return calls


def test_the_cpu_runs_the_library_ops_and_counts_nothing(monkeypatch):
  calls = []
  real = upconv2x2.upconv2x2_kernel
  monkeypatch.setattr(upconv2x2, 'upconv2x2_kernel',
                      lambda *a: calls.append(a) or real(*a))
  model = _released_model()
  x0, x1, t = _frames()
  _kernels.reset_launch_counts()
  with torch.no_grad():
    model(x0, x1, t)
  assert calls == []
  assert _kernels.launch_counts()['upconv2x2'] == 0


@pytest.mark.parametrize('policy,tf32', [('bfloat16', False),
                                         ('float32', True)])
def test_the_packed_route_takes_the_kernel_at_three_levels(routes, policy,
                                                           tf32, monkeypatch):
  # The released widths at 64x128: conv_0_0, conv_1_0 and conv_2_0 take
  # the kernel; the coarsest level's conv_3_0 (1936 packed channels, its
  # weights gathered) keeps the library ops. The prediction is the
  # concat route's, which runs the library ops at every level.
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  model = _released_model(seed=4, dtype_policy=policy)
  x0, x1, t = _frames(seed=5)
  want = model(x0, x1, t)['image'].detach()
  assert routes == {'kernel': 0, 'library': 4}
  routes.update(kernel=0, library=0)
  with torch.no_grad():
    got = model(x0, x1, t)['image']
  assert routes == {'kernel': 3, 'library': 1}
  bound = 1e-5 if policy == 'float32' else 2e-2
  assert float((got - want).abs().max()) <= bound * float(want.abs().max())


def test_exact_f32_keeps_the_library_ops(routes, monkeypatch):
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
  model = _released_model(seed=6, dtype_policy='float32')
  x0, x1, t = _frames(seed=7)
  with torch.no_grad():
    model(x0, x1, t)
  assert routes == {'kernel': 0, 'library': 4}


def test_a_row_sharded_forward_keeps_the_library_ops(routes):
  # The tiny config at the released filters: conv_0_0 (128->64) tiles,
  # conv_1_0 reads the coarsest packed level. Over 2 row shards each
  # shard runs the concat route: the library ops at both levels.
  options = Options.tiny(filters=64)
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(8))
  rng = np.random.RandomState(9)
  x0, x1 = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  state = model.state_dict()
  with torch.backends.cudnn.flags(allow_tf32=True):
    want = Interpolator(state, options, align=16, device='cpu')(x0, x1, dt)
    assert routes == {'kernel': 1, 'library': 1}
    routes.update(kernel=0, library=0)
    got = parallel.SpatialShardedInterpolator(
        state, options, parallel.Mesh(['cpu'] * 2), align=16)(x0, x1, dt)
  assert routes == {'kernel': 0, 'library': 4}
  assert float(np.abs(got - want).max()) <= 1e-5


# ---- on the card ------------------------------------------------------------

# 1080p (coarse levels of a 1088x1920 pair) and UHD (2176x3840) sites:
# (N, h, w, Cin, Cout) of the coarse input.
SITES_1080P = [(1, 544, 960, 128, 64), (1, 272, 480, 256, 128),
               (1, 136, 240, 512, 256)]
SITE_UHD = (1, 1088, 1920, 128, 64)
# Ragged edges (h not a multiple of 4, w not of 16) and a batch of 2.
SITE_RAGGED = (2, 37, 45, 128, 128)
# Relative RMS gap to f64 on the raw operands (the TF32 rounding's own
# gap) and the least-squares scale against it, as
# tests/test_torch_conv_tf32.py bounds the conv's TF32 route; to f64 on
# the rounded operands, the f32 sums' drift, 5e-9 a term of K = 4 Cin, as
# chip_smoke.py bounds it.
RAW_RMS_BOUND = 3.5e-4
SCALE_BOUND = 1e-4
ROUNDED_RMS_BOUND_PER_K = 5e-9


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card; see the docstring)')
  _kernels.library()
  return torch.device('cuda')


def _ulp_of_scale(y: torch.Tensor) -> float:
  """One bf16 ulp at the largest magnitude of y."""
  return 2.0**(math.floor(math.log2(float(y.float().abs().max()))) - 7)


@pytest.mark.card
@pytest.mark.parametrize('site', SITES_1080P + [SITE_UHD, SITE_RAGGED])
def test_bf16_kernel_is_within_one_ulp_of_the_library_path(card, site):
  n, h, w, cin, cout = site
  conv = _layer(cin, cout, torch.bfloat16, seed=h, device=card)
  x = _coarse(n, h, w, cin, seed=w, device=card).bfloat16()
  with torch.no_grad():
    got = upconv2x2.upconv2x2_kernel(x, conv.weight, conv.bias)
    plain = upconv2x2.upconv2x2_plain(x, conv.weight, conv.bias)
    library = conv(resize.resize_nearest(x, (2 * h, 2 * w)))
  torch.cuda.synchronize()
  ulp = _ulp_of_scale(plain)
  assert float((got.float() - plain.float()).abs().max()) <= ulp
  assert float((got.float() - library.float()).abs().max()) <= ulp


def _rel_rms(got, want):
  diff = got.double() - want
  return float((diff.square().sum() / want.square().sum()).sqrt())


@pytest.mark.card
@pytest.mark.parametrize('site', SITES_1080P + [SITE_UHD, SITE_RAGGED])
def test_tf32_kernel_rounds_its_operands(card, site):
  n, h, w, cin, cout = site
  conv = _layer(cin, cout, torch.float32, seed=h, device=card)
  x = _coarse(n, h, w, cin, seed=w, device=card)
  with torch.backends.cudnn.flags(allow_tf32=True), torch.no_grad():
    got = upconv2x2.upconv2x2_kernel(x, conv.weight, conv.bias)
  torch.cuda.synchronize()
  bias = conv.bias.detach().double()
  raw = upconv2x2.upconv2x2_plain(x.double(), conv.weight.double(), bias)
  rounded = upconv2x2.upconv2x2_plain(
      conv_weights.round_tf32(x).double(),
      conv_weights.round_tf32(conv.weight.detach()).double(), bias)
  scale = float((got.double() * raw).sum() / raw.square().sum())
  assert _rel_rms(got, raw) <= RAW_RMS_BOUND
  assert abs(scale - 1.0) <= SCALE_BOUND
  assert _rel_rms(got, rounded) <= ROUNDED_RMS_BOUND_PER_K * 4 * cin


@pytest.mark.card
@pytest.mark.parametrize('policy,tf32,grad,launches', [
    ('bfloat16', False, False, 3), ('bfloat16', False, True, 0),
    ('float32', True, False, 3), ('float32', False, False, 0)])
def test_a_midpoint_counts_three_upconv_launches(card, policy, tf32, grad,
                                                 launches):
  model = _released_model(dtype_policy=policy).to(card)
  g = torch.Generator().manual_seed(3)
  x0, x1 = (torch.rand(1, 128, 192, 3, generator=g).to(card)
            for _ in range(2))
  _kernels.reset_launch_counts()
  with torch.backends.cudnn.flags(allow_tf32=tf32), (
      torch.set_grad_enabled(grad)):
    model(x0, x1, torch.full((1, 1), 0.5, device=card))
  assert _kernels.launch_counts()['upconv2x2'] == launches
