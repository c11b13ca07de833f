"""The fusion's input built in place (models/film_net.py), on the CPU.

Where no gradient is asked for, each aligned level is one buffer in the
fusion's packed layout (models/fusion.py) whose channels the warps
(ops/warp.backward_warp_into), the flows and the pad's fill write; the
fusion reads it with its weights gathered into that order. Held here: the
buffer against the concat layout bit for bit at the released widths; the
gathered weights against the layer's own; the whole forward against the
concat path; which route a grad-recording forward and a row-sharded one
take, seen by the warps into a buffer each route calls. On the CPU those
copy the plain warp into the slice and launch nothing, so `warp_slice`
stays 0 (tests/test_torch_warp_into.py counts the card's 20).
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu_torch import parallel
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.models import film_net, fusion, layers
from frame_interpolation_tpu_torch.ops import _kernels
from frame_interpolation_tpu_torch.ops import pyramid as pyramid_ops
from frame_interpolation_tpu_torch.ops import warp
from frame_interpolation_tpu_torch.options import Options

torch.set_num_threads(2)


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
def into_calls(monkeypatch):
  """The channel offset of each call of ops/warp.backward_warp_into, the
  in-place route's warps, from the moment the fixture is taken."""
  calls = []
  real = warp.backward_warp_into

  def spy(image, flow, out, channel):
    calls.append(channel)
    return real(image, flow, out, channel)

  monkeypatch.setattr(warp, 'backward_warp_into', spy)
  return calls


def _counted(calls, fn, *args):
  # fn's output and the number of warps into a buffer it made; the CPU's
  # copies into the slice launch no kernel.
  calls.clear()
  _kernels.reset_launch_counts()
  out = fn(*args)
  assert _kernels.launch_counts()['warp_slice'] == 0
  return out, len(calls)


@pytest.mark.parametrize('c,channels', [(64, 144), (192, 400), (448, 912),
                                        (960, 1936), (4, 24), (12, 40)])
def test_packed_layout_is_a_multiple_of_8_with_aligned_feature_slices(
    c, channels):
  layout = fusion.packed_layout(c)
  assert layout.channels == channels and channels % 8 == 0
  assert (layout.features0, layout.features1) == (0, c)
  assert (layout.image0, layout.image1) == (2 * c, 2 * c + 3)
  assert (layout.backward_flow, layout.forward_flow) == (2 * c + 6, 2 * c + 8)
  assert layout.pad == 2 * c + 10 == fusion.aligned_channels(c)
  order = fusion.packed_order(c)
  # Every concat channel once, the pad's channels none.
  assert sorted(o for o in order if o >= 0) == list(range(layout.pad))
  assert order[layout.pad:] == (-1,) * (channels - layout.pad)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_buffer_is_the_concat_in_packed_order_bit_for_bit(dtype):
  # The released layout at 64x128: five fusion levels of 64, 192, 448,
  # 960 and 960 feature channels, flows far enough to clamp at the edges.
  options = Options.film_net_released()
  model = film_net.create_model(options)
  g = torch.Generator().manual_seed(1)
  images, features, flows = [[], []], [[], []], [[], []]
  for level in range(options.fusion_pyramid_levels):
    h, w = 64 >> level, 128 >> level
    for k in range(2):
      images[k].append(torch.rand(1, h, w, 3, generator=g).to(dtype))
      features[k].append(torch.randn(1, h, w, options.feature_channels(level),
                                     generator=g).to(dtype))
      flows[k].append(8 * torch.randn(1, h, w, 2, generator=g))
  with torch.no_grad():
    packed = model.fusion.align_in_place(images, features, *flows)
  want = pyramid_ops.concatenate_pyramids(
      pyramid_ops.pyramid_warp(
          pyramid_ops.concatenate_pyramids(images[0], features[0]), flows[0]),
      pyramid_ops.pyramid_warp(
          pyramid_ops.concatenate_pyramids(images[1], features[1]),
          flows[1]))
  want = pyramid_ops.concatenate_pyramids(
      want, [f.to(dtype) for f in flows[0]])
  want = pyramid_ops.concatenate_pyramids(
      want, [f.to(dtype) for f in flows[1]])
  for level, (buffer, concat) in enumerate(zip(packed, want)):
    c = options.feature_channels(level)
    layout = fusion.packed_layout(c)
    assert buffer.shape[-1] == layout.channels
    assert buffer.shape[-1] == (144, 400, 912, 1936, 1936)[level]
    assert buffer.dtype == dtype and buffer.is_contiguous()
    order = torch.tensor(fusion.packed_order(c))
    kept = order >= 0
    assert torch.equal(buffer[..., kept], concat[..., order[kept]]), level
    assert torch.equal(buffer[..., layout.pad:],
                       torch.zeros_like(buffer[..., layout.pad:]))


def test_warp_into_writes_its_slice_alone():
  g = torch.Generator().manual_seed(2)
  image = torch.rand(2, 6, 9, 3, generator=g)
  flow = 3 * torch.randn(2, 6, 9, 2, generator=g)
  out = torch.full((2, 6, 9, 16), 7.0)
  _kernels.reset_launch_counts()
  warp.backward_warp_into(image, flow, out, 5)
  # A copy into the slice, not a launch.
  assert _kernels.launch_counts()['warp_slice'] == 0
  assert torch.equal(out[..., 5:8], warp.backward_warp_plain(image, flow))
  assert (out[..., :5] == 7.0).all() and (out[..., 8:] == 7.0).all()
  with pytest.raises(ValueError, match='leave'):
    warp.backward_warp_into(image, flow, out, 14)
  with pytest.raises(ValueError, match='dtype|bfloat16'):
    warp.backward_warp_into(image, flow, out.bfloat16(), 0)


@pytest.mark.parametrize('split', [True, False], ids=['pieces', 'concat'])
def test_gathered_weights_convolve_the_packed_input_as_the_concat(split):
  # conv_0_1 of the tiny config on an aligned level and upsampled features:
  # the concat layout with the layer's weight, and the packed layout with
  # the gathered one, as pieces or as their concat.
  options = Options.tiny()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(3))
  conv = model.fusion.conv_0_1
  c = options.feature_channels(0)
  g = torch.Generator().manual_seed(4)
  concat = torch.randn(2, 8, 12, fusion.aligned_channels(c), generator=g)
  rest = torch.randn(2, 8, 12, options.filters, generator=g)
  order = torch.tensor(fusion.packed_order(c))
  packed = torch.zeros(2, 8, 12, len(order))
  packed[..., order >= 0] = concat[..., order[order >= 0]]
  order_0_1 = model.fusion._packed_orders['conv_0_1']
  with torch.no_grad():
    want = conv([concat, rest])
    pieces = [packed, rest] if split else torch.cat([packed, rest], -1)
    widths = (len(order), options.filters) if split else (
        len(order) + options.filters,)
    weights = fusion.gathered(conv, order_0_1, widths)
    got = conv.conv(pieces, weights)
  assert [tuple(w.shape[:2]) for w in weights] == [
      (conv.weight.shape[0], n) for n in widths]
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
  # Made once: the same tensors again, until the weight is written to.
  assert fusion.gathered(conv, order_0_1, widths)[0] is weights[0]
  with torch.no_grad():
    conv.weight.mul_(2.0)
  again = fusion.gathered(conv, order_0_1, widths)
  assert again[0] is not weights[0]
  torch.testing.assert_close(again[0], 2.0 * weights[0])


def test_inference_forward_matches_the_concat_path_and_counts_20(into_calls):
  # Released widths at 64x128. A grad-recording forward takes the concat
  # path; under no_grad and inference mode the in-place one, 4 warps into
  # each of the 5 levels' buffers.
  model = _released_model()
  x0, x1, t = _frames()
  want, concat_count = _counted(into_calls, model, x0, x1, t)
  assert want['image'].requires_grad and concat_count == 0
  want = {k: v.detach() for k, v in want.items() if torch.is_tensor(v)}
  for mode in (torch.no_grad, torch.inference_mode):
    with mode():
      got, count = _counted(into_calls, model, x0, x1, t)
    assert count == 20
    for key in ('image', 'x0_warped', 'x1_warped'):
      scale = float(want[key].abs().max())
      assert float((got[key] - want[key]).abs().max()) <= 1e-5 * scale, key


def test_grad_forward_takes_the_concat_path_with_its_gradients(monkeypatch,
                                                               into_calls):
  model = _released_model(seed=5)
  x0, x1, t = _frames(seed=6)
  calls = []
  real = pyramid_ops.concatenate_pyramids

  def counted(a, b):
    calls.append(len(a))
    return real(a, b)

  monkeypatch.setattr(pyramid_ops, 'concatenate_pyramids', counted)
  out, count = _counted(into_calls, model, x0, x1, t)
  out['image'].mean().backward()
  assert count == 0
  # The two (image, features) stacks and the three aligned concats, each
  # over the 5 fusion levels.
  assert calls == [5] * 5
  grads = {n: p.grad for n, p in model.named_parameters()}
  assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
  assert all(float(g.abs().max()) > 0
             for n, g in grads.items() if n.startswith('fusion.'))
  # The same step from a forward whose inputs need no gradient but whose
  # weights do (as training's): the concat path again.
  calls.clear()
  model.zero_grad()
  features = []
  for x in (x0, x1):
    images, feature_pyramid = model.extract_features(x)
    features.append(([level.detach() for level in images],
                     [level.detach() for level in feature_pyramid]))
  out, count = _counted(into_calls, model.interpolate_from_features,
                        *features, t)
  out['image'].mean().backward()
  assert count == 0 and calls == [5] * 5
  assert float(model.fusion.conv_0_1.weight.grad.abs().max()) > 0


def test_row_sharded_forward_takes_the_concat_path(into_calls):
  options = Options.tiny()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(7))
  rng = np.random.RandomState(8)
  x0, x1 = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  state = model.state_dict()
  want, count = _counted(
      into_calls, Interpolator(state, options, align=16, device='cpu'), x0,
      x1, dt)
  assert count == 4 * options.fusion_pyramid_levels
  got, count = _counted(
      into_calls, parallel.SpatialShardedInterpolator(
          state, options, parallel.Mesh(['cpu'] * 2), align=16),
      x0, x1, dt)
  assert count == 0
  assert float(np.abs(got - want).max()) <= 1e-5


def test_the_layer_refuses_pieces_that_do_not_match_its_weight():
  conv = layers.Conv(5, 2, 3, torch.float32)
  with pytest.raises(ValueError, match='pieces of 4 channels'):
    conv([torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 1)])
  with pytest.raises(ValueError, match='an order of 5'):
    fusion.gathered(conv, (0, 1, 2, 3, 4), (2, 2))
