"""The conv kernel's TF32 route (csrc/conv3x3.cu, fi_conv3x3_tf32) rounds
its operands to nearest TF32, as cuDNN does.

On the CPU: the TF32 route's weight pack is film_bench's plain
`round_tf32` of the exact pack bit for bit, the exact f32 route's pack
stays unrounded, the pack cache keeps the two apart, the rounding is to
the nearer TF32 neighbour with ties away from zero, and the wrapper hands
the TF32 entry point the rounded pack and counts `conv3x3_tf32` on that
route alone.

Marked `card` (skipped without a CUDA device; on the card, where JAX is
missing, run with `--noconftest`):

  python -m pytest --noconftest -p no:cacheprovider -m card \
      tests/test_torch_conv_tf32.py

At 8x64x64 128->128, 8x32x32 256->512 and 272x480 128->256, three seeds
each: the TF32 route against f64 on the raw operands (the rounding's own
gap, about 2.9e-4 relative RMS; a truncating route reads 7.7e-4, every
output shrunk by 7e-4) and against f64 on the rounded operands (only the
f32 sums' error). The bf16 and exact f32 routes are held to their plain
versions with chip_smoke.py's bounds. An f32 pair of the released model
under TF32 takes the TF32 route at all 62 sites, and none in bf16.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from film_bench.reference.tf32 import round_tf32 as plain_round_tf32
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack

# Relative RMS gap to f64 on the raw operands: rounding each operand to
# 11 significant bits leaves about 2.9e-4 over these sums; truncating
# leaves 7.7e-4.
RAW_RMS_BOUND = 3.5e-4
# The least-squares scale of the output against f64: 1 where rounding is
# unbiased; a truncating route reads 1 - 7e-4.
SCALE_BOUND = 1e-4
# Relative RMS gap to f64 on the rounded operands: the f32 sums alone.
ROUNDED_RMS_BOUND = 1e-5
# Max |kernel - plain| / max |plain|, as chip_smoke.py bounds the routes.
BF16_BOUND = 1e-2
F32_BOUND = 1e-4
SHAPES = [(8, 64, 64, 128, 128), (8, 32, 32, 256, 512),
          (1, 272, 480, 128, 256)]


def _special_values() -> torch.Tensor:
  """f32 values at the rounding's edges: exact ties (the 13 dropped bits
  0x1000) either way of zero, just below and above a tie, a mantissa that
  carries into the exponent, subnormals, zeros, and TF32 values."""
  bits = []
  for base in (0x3F800000, 0x3FAAA000, 0x00400000, 0x7F000000):
    for low in (0x0000, 0x0FFF, 0x1000, 0x1001, 0x1FFF):
      bits += [base | low, (base | low) | 0x80000000]
  bits += [0x3FFFF000, 0x3FFFFFFF, 0x00000001, 0x00001000, 0x80000000, 0]
  return torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(
      torch.float32)


def _int_bits(x: torch.Tensor) -> torch.Tensor:
  return x.contiguous().view(torch.int32)


def test_round_tf32_takes_the_nearer_neighbour_ties_away():
  g = torch.Generator().manual_seed(0)
  x = torch.cat([_special_values(), torch.randn(4096, generator=g) *
                 torch.exp(torch.randn(4096, generator=g) * 8)])
  bits = x.numpy().view(np.uint32).astype(np.int64)
  down = (bits & 0xFFFFE000).astype(np.uint32).view(np.float32)
  up = ((bits & 0xFFFFE000) + 0x2000).astype(np.uint32).view(np.float32)
  exact = x.double().numpy()
  gap_down = np.abs(exact - down.astype(np.float64))
  gap_up = np.abs(up.astype(np.float64) - exact)
  # The nearer neighbour in magnitude; at a tie the one away from zero.
  want = np.where(gap_up <= gap_down, up, down)
  for rounded in (conv_stack.round_tf32(x), plain_round_tf32(x)):
    assert np.array_equal(rounded.numpy().view(np.uint32),
                          want.view(np.uint32))
    assert not (rounded.numpy().view(np.uint32) & 0x1FFF).any()


def test_tf32_pack_is_round_tf32_bit_for_bit():
  g = torch.Generator().manual_seed(1)
  weight = torch.nn.Parameter(torch.randn(64, 32, 3, 3, generator=g) * 0.05)
  with torch.no_grad():
    weight.view(-1)[:_special_values().numel()] = _special_values()
  packed = conv_stack._packed_weight(weight, torch.float32, tf32=True)
  exact = weight.detach().permute(0, 2, 3, 1).contiguous()
  assert packed.dtype == torch.float32 and packed.is_contiguous()
  assert torch.equal(_int_bits(packed), _int_bits(plain_round_tf32(exact)))


def test_exact_f32_pack_stays_unrounded():
  g = torch.Generator().manual_seed(2)
  weight = torch.nn.Parameter(torch.randn(64, 64, 3, 3, generator=g))
  exact = conv_stack._packed_weight(weight, torch.float32)
  want = weight.detach().permute(0, 2, 3, 1).contiguous()
  assert torch.equal(_int_bits(exact), _int_bits(want))
  assert (_int_bits(exact) & 0x1FFF).any()
  # The weight itself is never rounded in place.
  assert (_int_bits(weight.detach()) & 0x1FFF).any()


def test_pack_cache_keeps_the_routes_apart():
  weight = torch.nn.Parameter(torch.randn(64, 64, 3, 3))
  exact = conv_stack._packed_weight(weight, torch.float32)
  rounded = conv_stack._packed_weight(weight, torch.float32, tf32=True)
  bf16 = conv_stack._packed_weight(weight, torch.bfloat16)
  assert len({exact.data_ptr(), rounded.data_ptr(), bf16.data_ptr()}) == 3
  assert not torch.equal(exact, rounded)
  # Each route gets its own copy back, whichever was packed last.
  assert conv_stack._packed_weight(weight, torch.float32) is exact
  assert conv_stack._packed_weight(weight, torch.float32, True) is rounded
  assert conv_stack._packed_weight(weight, torch.bfloat16) is bf16
  with torch.no_grad():
    weight.mul_(3.0)
  for tf32 in (False, True):
    repacked = conv_stack._packed_weight(weight, torch.float32, tf32)
    want = weight.detach().permute(0, 2, 3, 1).contiguous()
    want = conv_stack.round_tf32(want) if tf32 else want
    assert torch.equal(_int_bits(repacked), _int_bits(want))


@pytest.mark.parametrize('dtype,tf32,symbol', [
    (torch.bfloat16, True, 'fi_conv3x3_bf16'),
    (torch.bfloat16, False, 'fi_conv3x3_bf16'),
    (torch.float32, True, 'fi_conv3x3_tf32'),
    (torch.float32, False, 'fi_conv3x3_f32')])
def test_only_the_tf32_route_reads_rounded_weights_and_counts(
    monkeypatch, dtype, tf32, symbol):
  calls = {}

  class _Library:

    def __getattr__(self, name):
      def call(*args):
        calls[name] = args
        return 1 if name == 'fi_conv3x3_f32_splits' else 0
      return call

  monkeypatch.setattr(_kernels, 'library', _Library)
  monkeypatch.setattr(_kernels, 'require_cuda', lambda *a, **k: None)
  monkeypatch.setattr(_kernels, 'stream_of', lambda t: 0)
  monkeypatch.setattr(_kernels, 'LAUNCHES', dict.fromkeys(_kernels.LAUNCHES,
                                                          0))
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  weight = torch.nn.Parameter(torch.randn(128, 64, 3, 3))
  x = torch.zeros(1, 4, 6, 64, dtype=dtype)
  conv_stack.conv3x3_leaky_kernel(x, weight, torch.zeros(128))
  on_tf32 = symbol == 'fi_conv3x3_tf32'
  packed = conv_stack._packed_weight(weight, dtype, on_tf32)
  assert calls[symbol][1] == packed.data_ptr()
  assert _kernels.LAUNCHES == dict.fromkeys(_kernels.LAUNCHES, 0) | {
      'conv3x3_wide': 1, 'conv3x3_tf32': int(on_tf32)}


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card; see the docstring)')
  _kernels.library()
  return torch.device('cuda')


@pytest.fixture
def tf32_on():
  saved = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = True
  yield
  torch.backends.cudnn.allow_tf32 = saved


def _operands(seed, n, h, w, cin, cout, device):
  g = torch.Generator().manual_seed(seed)
  x = torch.rand(n, h, w, cin, generator=g) * 2 - 1
  weight = torch.randn(cout, cin, 3, 3, generator=g) * (9.0 * cin)**-0.5
  return x.to(device), weight.to(device)


def _f64_conv(x, weight):
  """leaky(conv3x3(x, w)) in f64, NHWC, no bias."""
  y = F.conv2d(x.double().permute(0, 3, 1, 2), weight.double(), padding=1)
  y = torch.where(y >= 0, y, 0.2 * y)
  return y.permute(0, 2, 3, 1)


def _rel_rms(got, want):
  diff = got.double() - want
  return float((diff.square().sum() / want.square().sum()).sqrt())


@pytest.mark.card
@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('shape', SHAPES)
def test_tf32_route_rounds_its_operands(card, tf32_on, shape, seed):
  x, weight = _operands(seed, *shape, card)
  bias = torch.zeros(shape[-1], device=card)
  got, _ = conv_stack.conv3x3_leaky_kernel(x, weight, bias)
  torch.cuda.synchronize()
  raw = _f64_conv(x, weight)
  rounded = _f64_conv(plain_round_tf32(x), plain_round_tf32(weight))
  scale = float((got.double() * raw).sum() / raw.square().sum())
  assert _rel_rms(got, raw) <= RAW_RMS_BOUND
  assert abs(scale - 1.0) <= SCALE_BOUND
  assert _rel_rms(got, rounded) <= ROUNDED_RMS_BOUND


@pytest.mark.card
@pytest.mark.parametrize('dtype,bound', [(torch.bfloat16, BF16_BOUND),
                                         (torch.float32, F32_BOUND)])
@pytest.mark.parametrize('shape', SHAPES)
def test_bf16_and_exact_routes_keep_their_plain_bounds(card, shape, dtype,
                                                       bound):
  saved = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    x, weight = _operands(7, *shape, card)
    x = x.to(dtype)
    bias = torch.randn(shape[-1], generator=torch.Generator().manual_seed(
        7)).mul_(0.1).to(card)
    for pool in (False, True):
      got = conv_stack.conv3x3_leaky_kernel(x, weight, bias, pool)
      want = conv_stack.conv3x3_leaky_plain(x, weight, bias, pool)
      for g, p in zip(got, want):
        if p is None:
          continue
        err = float((g.float() - p.float()).abs().max())
        assert err <= bound * float(p.float().abs().max())
  finally:
    torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.card
@pytest.mark.parametrize('dtype_policy,tf32_sites', [('float32', 62),
                                                     ('bfloat16', 0)])
def test_a_pair_takes_the_tf32_route_at_every_site_in_f32(card, tf32_on,
                                                         dtype_policy,
                                                         tf32_sites):
  from frame_interpolation_tpu_torch.models import create_model, init_params
  from frame_interpolation_tpu_torch.options import Options
  options = Options.film_net_released(dtype_policy=dtype_policy)
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).to(card)
  g = torch.Generator().manual_seed(3)
  x0, x1 = (torch.rand(1, 128, 192, 3, generator=g).to(card)
            for _ in range(2))
  _kernels.reset_launch_counts()
  with torch.no_grad():
    model(x0, x1, torch.full((1, 1), 0.5, device=card))
  counts = _kernels.launch_counts()
  assert counts['conv3x3_c64'] + counts['conv3x3_wide'] == 62
  assert counts['conv3x3_tf32'] == tf32_sites
