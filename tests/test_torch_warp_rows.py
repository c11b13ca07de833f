"""The row-sharded forward's ops on the CPU: the row-mode warp and halos.

The row-mode plain warp is held against the JAX package (its full-frame
warp sliced to the slab, and the window kernel's row mode in the Pallas
interpreter). Each op that reaches across rows (ops/rows.py) runs on a
mesh of n CPU shards, n in {1, 2, 4}, against the same op on the whole
frame: the 3x3 and 2x2 convs, the upsamples, the pool, the extractor's
conv stack with its 2-row halo and conv0's masking, and the warp, with
split and unsplit levels. Port-only but for the two JAX comparisons.
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.ops import warp as jax_warp
from frame_interpolation_tpu.ops import warp_window as jax_window
from frame_interpolation_tpu_torch.models.layers import Conv, leaky_relu
from frame_interpolation_tpu_torch.ops import (conv_stack, pyramid, resize,
                                               rows, warp)
from frame_interpolation_tpu_torch.parallel import shard_map

torch.set_num_threads(2)

B, H, W, C = 2, 32, 24, 5


def _flow(seed, max_dy, max_dx=30.0, h=H, w=W, b=B):
  """A smooth flow with |dy| <= max_dy; dx reaches past the frame."""
  rng = np.random.RandomState(seed)
  flow = (rng.rand(b, h, w, 2) * 2 - 1).astype(np.float32)
  flow[..., 0] *= max_dx
  flow[..., 1] *= max_dy
  # Whole-pixel steps and exact halves: the floor's and the clamp's edges.
  flow[:, ::5, ::3] = np.round(flow[:, ::5, ::3] * 2) / 2
  return flow


@pytest.fixture(scope='module')
def frame():
  rng = np.random.RandomState(0)
  image = rng.rand(B, H, W, C).astype(np.float32)
  flows = {'small': _flow(1, 7.0), 'large': _flow(2, 2.2 * H)}
  # One JAX compile: the full-frame warp, for both flows.
  want = {k: np.asarray(jax_warp.backward_warp(image, f))
          for k, f in flows.items()}
  return image, flows, want


def _slabs(image, n):
  """The frame's rows as n equal slabs, each a tensor of its own."""
  return [t.clone() for t in torch.from_numpy(image).chunk(n, dim=1)]


def _extension(image, row0, slab, k):
  """Global rows [row0 - k*slab, row0 + (k+1)*slab), zeros beyond."""
  lo, hi = row0 - k * slab, row0 + (k + 1) * slab
  ext = np.zeros((image.shape[0], hi - lo) + image.shape[2:], image.dtype)
  a, b = max(lo, 0), min(hi, image.shape[1])
  ext[:, a - lo:b - lo] = image[:, a:b]
  return ext, lo


@pytest.mark.parametrize('n,k,flow_kind', [
    (1, 0, 'large'), (2, 0, 'small'), (4, 0, 'large'), (4, 1, 'small'),
    (2, 1, 'small')])
def test_rows_plain_matches_jax_full_frame_slices(frame, n, k, flow_kind):
  # n shards' output rows; the frame's rows as n * (k + 1) slabs.
  image, flows, want = frame
  flow = flows[flow_kind]
  slab = H // n
  slabs = _slabs(image, n * (k + 1))
  for d in range(n):
    row0 = d * slab
    got = warp.backward_warp_rows_plain(
        slabs, torch.from_numpy(flow[:, row0:row0 + slab]), row0, H)
    # The tolerance of the port's full-frame warp parity test.
    np.testing.assert_allclose(got.numpy(), want[flow_kind][:, row0:row0 +
                                                            slab],
                               rtol=0, atol=1e-5)


def test_query_coords_row_mode_shifts_only_the_row_corner(frame):
  _, flows, _ = frame
  flow = torch.from_numpy(flows['large'][:, 8:16])
  full = warp.query_coords(H, W, torch.from_numpy(flows['large']))
  slab = warp.query_coords(24, W, flow, row_offset=8, src_row0=-8,
                           clamp_h=H)
  assert torch.equal(slab[0], full[0][:, 8:16] + 8)
  for a, b in zip(slab[1:], full[1:]):
    assert torch.equal(a, b[:, 8:16])


def test_rows_plain_matches_the_window_kernel_row_mode(frame):
  image, flows, _ = frame
  flow = flows['small']
  slab, k = 8, 1
  # One JAX compile: the Pallas window kernel in its row mode, in the
  # interpreter, on the extension of a middle slab and of the first.
  for row0 in (8, 0):
    source, src_row0 = _extension(image, row0, slab, k)
    want = jax_window._forward(source, flow[:, row0:row0 + slab],
                               interpret=True, g=1, row_offset=row0,
                               src_row0=src_row0, clamp_h=H)
    got = warp.backward_warp_rows_plain(
        _slabs(image, H // slab), torch.from_numpy(flow[:, row0:row0 + slab]),
        row0, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_rows_plain_refuses_rows_beyond_the_frame():
  slabs = [torch.zeros(1, 4, 6, 3), torch.zeros(1, 4, 6, 3)]
  flow = torch.zeros(1, 4, 6, 2)
  with pytest.raises(ValueError, match='leave the frame'):
    warp.backward_warp_rows_plain(slabs, flow, 6, 8)
  with pytest.raises(ValueError, match='batch and width'):
    warp.backward_warp_rows_plain(slabs, torch.zeros(1, 4, 5, 2), 0, 8)
  with pytest.raises(ValueError, match="make the frame's"):
    warp.backward_warp_rows_plain(slabs, flow, 0, 10)
  with pytest.raises(ValueError, match='differ in shape'):
    warp.backward_warp_rows_plain([slabs[0], torch.zeros(1, 3, 6, 3)], flow,
                                  0, 7)


# ---- the halos: n CPU shards against the whole frame ------------------------


def _sharded(n, height, width, fn, *planes):
  """fn(shard, *slabs) on n CPU shards of a (height, width) frame; each
  plane is split by rows where its level splits. Returns each shard's
  output."""
  collective = shard_map.Collective(n, timeout=60)

  def run(index):
    shard = rows.RowShard(collective, index, height, width)
    parts = [shard.take(p) if shard.split(p) else p for p in planes]
    with rows.sharding(shard):
      return fn(shard, *parts)

  return shard_map.run_shards(run, [torch.device('cpu')] * n, collective)


def _joined(outs, split):
  return torch.cat(outs, dim=1) if split else outs[0]


def _image(seed, b, h, w, c):
  return torch.from_numpy(
      np.random.RandomState(seed).rand(b, h, w, c).astype(np.float32))


@pytest.fixture(scope='module')
def convs():
  gen = torch.Generator().manual_seed(0)
  layers = {}
  for k in (1, 2, 3):
    conv = Conv(4, 6, k, torch.float32)
    conv.reset_parameters(gen)
    with torch.no_grad():
      conv.bias.normal_(generator=gen)
    layers[k] = conv
  return layers


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('k', [3, 2, 1])
@pytest.mark.parametrize('h,w', [(32, 12), (24, 10)])
def test_conv_halo_matches_the_whole_frame(convs, n, k, h, w):
  # 24 rows over 4 shards split into slabs of 6; 32 into 8; each level's
  # own gate decides.
  x = _image(1, 2, h, w, 4)
  want = convs[k](x)
  outs = _sharded(n, h, w, lambda s, a: convs[k](a), x)
  got = _joined(outs, rows.splits(h, n))
  torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('fn', ['bilinear', 'nearest'])
@pytest.mark.parametrize('h,w', [(32, 12), (32, 11), (24, 10)])
def test_upsample_halo_matches_the_whole_frame(n, fn, h, w):
  # (24, 10) over 4: the 12-row level below splits into odd slabs of 3,
  # so the upsample takes its rows out of the whole plane.
  resize_fn = resize.resize_bilinear if fn == 'bilinear' else (
      resize.resize_nearest)
  coarse = _image(2, 2, h // 2, w // 2, 3)
  want = resize_fn(coarse, (h, w))
  outs = _sharded(n, h, w, lambda s, a: resize_fn(a, (h // n, w)), coarse)
  got = _joined(outs, rows.splits(h, n))
  assert torch.equal(got, want)


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('h,w', [(32, 12), (24, 10), (20, 9)])
def test_pool_matches_the_whole_frame(n, h, w):
  # 24 over 4: slabs of 6 pool to 3-row slabs, which do not split: the
  # pooled plane is gathered whole. 20 over 4: nothing splits.
  x = _image(3, 2, h, w, 3)
  want = pyramid.avg_pool_2x(x)
  outs = _sharded(n, h, w, lambda s, a: pyramid.avg_pool_2x(a), x)
  got = _joined(outs, rows.splits(h, n) and rows.splits(h // 2, n))
  assert torch.equal(got, want)


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('first_kind', ['plain', 'kernel'])
@pytest.mark.parametrize('h,w,pool', [(32, 12, True), (16, 10, False),
                                      (24, 10, True)])
def test_conv_stack_rows_matches_the_whole_frame(n, first_kind, h, w, pool):
  gen = torch.Generator().manual_seed(1)
  first = Conv(4, 8, 3, torch.float32)
  first.reset_parameters(gen)
  with torch.no_grad():
    # Biases that leave conv0 non-zero on a zero input, so conv0's output
    # on the halo rows beyond the frame must be masked, not taken.
    first.bias.uniform_(0.5, 1.0, generator=gen)
  weight = torch.randn(8, 8, 3, 3, generator=gen) * 0.2
  bias = torch.randn(8, generator=gen)

  def first_conv(x):
    if first_kind == 'kernel':
      return conv_stack.conv3x3_leaky(x, first.weight, first.bias)[0]
    return leaky_relu(first.conv(x))

  x = _image(4, 2, h, w, 4)
  want_feat, want_pool = conv_stack.conv3x3_leaky(first_conv(x), weight,
                                                  bias, pool=pool)

  def run(shard, a):
    if not shard.split(a):
      return conv_stack.conv3x3_leaky(first_conv(a), weight, bias, pool=pool)
    return conv_stack.stack_rows(a, first_conv, weight, bias, pool, shard)

  outs = _sharded(n, h, w, run, x)
  split = rows.splits(h, n)
  torch.testing.assert_close(_joined([o[0] for o in outs], split),
                             want_feat, rtol=0, atol=1e-6)
  if pool:
    torch.testing.assert_close(_joined([o[1] for o in outs], split),
                               want_pool, rtol=0, atol=1e-6)


def test_stack_rows_masks_conv0_beyond_the_frame(monkeypatch):
  # conv0 of the zero halo rows beyond the frame is its bias, not the SAME
  # padding's zeros: unmasked, the edge slabs' features differ.
  x = _image(5, 1, 16, 8, 2)
  weight = torch.ones(2, 2, 3, 3) * 0.1
  bias = torch.zeros(2)

  def first_conv(t):
    return t + 1.0

  def run(shard, a):
    return conv_stack.stack_rows(a, first_conv, weight, bias, False, shard)[0]

  want = conv_stack.conv3x3_leaky(first_conv(x), weight, bias)[0]
  assert torch.equal(torch.cat(_sharded(2, 16, 8, run, x), dim=1), want)
  monkeypatch.setattr(conv_stack, 'apply_valid_rows', lambda y, valid: y)
  unmasked = torch.cat(_sharded(2, 16, 8, run, x), dim=1)
  assert not torch.equal(unmasked[:, 0], want[:, 0])
  assert not torch.equal(unmasked[:, -1], want[:, -1])
  assert torch.equal(unmasked[:, 1:-1], want[:, 1:-1])


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('flow_kind', ['small', 'large'])
def test_sharded_warp_matches_the_whole_frame(frame, n, flow_kind):
  image, flows, _ = frame
  x, flow = torch.from_numpy(image), torch.from_numpy(flows[flow_kind])
  want = warp.backward_warp(x, flow)
  outs = _sharded(n, H, W, lambda s, a, f: warp.backward_warp(a, f), x, flow)
  assert torch.equal(_joined(outs, rows.splits(H, n)), want)


def _record_sources(monkeypatch):
  calls = []
  plain = warp.backward_warp_rows_plain

  def spy(slabs, flow, row_offset, clamp_h):
    calls.append((row_offset, len(slabs), slabs[0].shape[1]))
    return plain(slabs, flow, row_offset, clamp_h)

  monkeypatch.setattr(warp, 'backward_warp_rows_plain', spy)
  return calls


def test_halo_predicate_takes_one_branch_on_every_shard(frame, monkeypatch):
  # The JAX kernel picks a halo or the whole frame by the flow's reach
  # (test_window_rows_halo_cond_falls_back_on_large_flow); the port's
  # row-mode warp has one branch whatever the flow: every shard reads the
  # 4 slabs where they lie, for small, large and mixed flows alike, and
  # nothing reads the flow on the host.
  image, flows, _ = frame
  calls = _record_sources(monkeypatch)
  x = torch.from_numpy(image)
  mixed = flows['small'].copy()
  mixed[:, 17, 3, 1] = -8.0  # shard 2 alone reaches past one slab
  expected = [(d * 8, 4, 8) for d in range(4)]
  for kind, flow in (('small', flows['small']), ('large', flows['large']),
                     ('mixed', mixed)):
    calls.clear()
    f = torch.from_numpy(flow)
    with monkeypatch.context() as m:
      m.setattr(torch.Tensor, 'item', _no_host_read)
      outs = _sharded(4, H, W, lambda s, a, b: warp.backward_warp(a, b), x, f)
    assert sorted(calls) == expected, kind
    assert torch.equal(torch.cat(outs, dim=1), warp.backward_warp(x, f))


def _no_host_read(*args):
  raise AssertionError('the row-sharded warp read a tensor on the host')
