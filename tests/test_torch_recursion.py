"""The port's recursion and frame-tree slice against the JAX package's, on
the CPU.

The tiny config with numpy-seeded weights (zero biases), carried to the JAX package
through io/params_io.to_flax_params. Held against JAX: the DFS schedule,
the exact uint8 rules, the host helpers (natural_sort, read_image_uint8,
fanout.shard), the reference-order recursion and the feature-cached tree
(per frame max-abs 1e-4 and PSNR 50 dB, the bounds of the pair forward in
test_torch_interpolator.py). Port-only: the cached DFS equals the uncached
DFS bit for bit (the same batch-1 forwards, only re-used); the cached tree
and the chunked tree, and the tiled tree and the legacy tiled loop, agree
to 1e-6 (other batch sizes, so float noise); the streaming driver equals
the frontier; paths, mixed dtypes and degenerate inputs.
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.inference import cached_tree as jax_cached_tree
from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.inference import recursion as jax_recursion
from frame_interpolation_tpu.io import images as jax_images
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.utils import fanout as jax_fanout
from frame_interpolation_tpu_torch.inference import (Interpolator,
                                                     cached_tree, recursion)
from frame_interpolation_tpu_torch.inference import interpolator
from frame_interpolation_tpu_torch.io import images, params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.utils import fanout

torch.set_num_threads(2)

JAX_BOUND = 1e-4       # max-abs per frame, port vs JAX (f32)
JAX_PSNR_DB = 50.0
NOISE_BOUND = 1e-6     # max-abs, the same model at other batch sizes
H, W, ALIGN = 30, 44, 16


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def tiny_state():
  """Lecun-normal kernels from a numpy seed and zero biases, as the port's
  init_params draws them."""
  rng = np.random.RandomState(1)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    if value.dim() == 4:
      array = rng.randn(*value.shape) * np.prod(value.shape[1:])**-0.5
    else:
      array = np.zeros(value.shape)
    state[name] = torch.from_numpy(array.astype(np.float32))
  return state


@pytest.fixture(scope='module')
def interp(tiny_state):
  return Interpolator(tiny_state, Options.tiny(), align=ALIGN, device='cpu')


@pytest.fixture(scope='module')
def jax_interpolator(tiny_state):
  return jax_interp.Interpolator(params_io.to_flax_params(tiny_state),
                                 JaxOptions.tiny(), align=ALIGN)


def _frames(n, h=H, w=W, seed=0):
  rng = np.random.RandomState(seed)
  return [rng.rand(h, w, 3).astype(np.float32) for _ in range(n)]


def _max_abs(a, b):
  return max(float(np.abs(np.asarray(x, np.float32) - y).max())
             for x, y in zip(a, b))


# ---- against the JAX package ------------------------------------------------


@pytest.mark.parametrize('times', range(6))
def test_dfs_schedule_matches_jax(times):
  got, want = cached_tree.dfs_schedule(times), jax_cached_tree.dfs_schedule(
      times)
  assert got.keys() == want.keys()
  for key in want:
    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got[key].dtype == want[key].dtype


def test_u8_to_f32_matches_jax_and_numpy_for_every_byte():
  values = np.arange(256, dtype=np.uint8)
  got = interpolator.u8_to_unit_f32(torch.from_numpy(values)).numpy()
  want = np.asarray(jax_interp._u8_to_unit_f32(values))
  assert got.dtype == np.float32
  np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
  np.testing.assert_array_equal(
      got.view(np.uint32),
      (values.astype(np.float32) / np.float32(255)).view(np.uint32))


def test_quantize_matches_to_uint8():
  rng = np.random.RandomState(3)
  x = (rng.rand(4, 9, 13, 3) * 1.6 - 0.3).astype(np.float32)
  # .5 boundaries after the scale, the ends, and values outside [0, 1].
  x[0, 0, :, 0] = (np.arange(13) + 0.5) / np.float32(255)
  x[0, 1, :3, 1] = [0.0, 1.0, -0.0]
  x[0, 2, :2, 2] = [-5.0, 7.0]
  got = cached_tree.quantize_u8(torch.from_numpy(x)).numpy()
  assert got.dtype == np.uint8
  np.testing.assert_array_equal(got, images.to_uint8(x))
  np.testing.assert_array_equal(got, jax_images.to_uint8(x))


def test_host_helpers_match_jax(tmp_path):
  names = ['frame_10.png', 'frame_2.png', 'a1b10', 'a1b9', 'frame_1.png', 'x']
  assert images.natural_sort(names) == jax_images.natural_sort(names)
  path = str(tmp_path / 'a.png')
  jax_images.write_image(path, _frames(1, 7, 11)[0])
  got = images.read_image_uint8(path)
  assert got.dtype == np.uint8
  np.testing.assert_array_equal(got, jax_images.read_image_uint8(path))
  items = list(range(11))
  for num_shards in (1, 2, 3):
    for index in range(num_shards):
      assert fanout.shard(items, index, num_shards) == jax_fanout.shard(
          items, index, num_shards)
  for bad in ((0, 0), (2, 2), (-1, 2)):
    with pytest.raises(ValueError):
      fanout.shard(items, *bad)


def test_recursion_and_cached_tree_match_jax(interp, jax_interpolator):
  frames = _frames(3)
  want = list(jax_recursion.interpolate_recursively(frames, 2,
                                                    jax_interpolator))
  want_tree = np.asarray(jax_interpolator.expand_tree_device(
      np.stack(frames), 2, cached=True))
  got = list(recursion.interpolate_recursively(frames, 2, interp))
  got_tree = interp.expand_tree_device(np.stack(frames), 2,
                                       cached=True).numpy()
  assert len(got) == len(want) == recursion.num_output_frames(3, 2) == 9
  assert got_tree.shape == want_tree.shape == (9, H, W, 3)
  for i in range(9):
    for a, b in ((got[i], want[i]), (got_tree[i], want_tree[i]),
                 (got_tree[i], want[i])):
      assert float(np.abs(a - b).max()) <= JAX_BOUND, i
      assert _psnr(a, b) >= JAX_PSNR_DB, i


# ---- the port's routes against each other -----------------------------------


def test_cached_dfs_equals_uncached_dfs_exactly(interp):
  frames = _frames(3, seed=1)
  uncached = list(recursion.interpolate_recursively(frames, 3, interp))
  cached = list(recursion.interpolate_recursively_cached(frames, 3, interp))
  tree = interp.expand_tree_device(np.stack(frames), 3, cached=True).numpy()
  assert len(uncached) == len(cached) == tree.shape[0] == 17
  for i, (a, b) in enumerate(zip(uncached, cached)):
    np.testing.assert_array_equal(a, b, err_msg=f'frame {i}')
    np.testing.assert_array_equal(a, tree[i], err_msg=f'frame {i}')
  quantized = list(recursion.interpolate_recursively_cached(
      frames, 3, interp, as_uint8=True))
  for a, b in zip(quantized, uncached):
    np.testing.assert_array_equal(a, images.to_uint8(b))


@pytest.mark.parametrize('n,times,max_batch', [(3, 2, 3), (4, 2, 4),
                                               (2, 3, 2)])
def test_cached_tree_matches_chunked_tree(interp, n, times, max_batch):
  frames = np.stack(_frames(n, seed=n))
  cached = interp.expand_tree_device(frames, times, cached=True).numpy()
  chunked = interp.expand_tree_device(frames, times, max_batch=max_batch,
                                      cached=False).numpy()
  assert cached.shape == chunked.shape == (
      recursion.num_output_frames(n, times), H, W, 3)
  assert float(np.abs(cached - chunked).max()) <= NOISE_BOUND
  # The chunked tree's uint8 output is its own f32 output quantized.
  quantized = interp.expand_tree_device(frames, times, max_batch=max_batch,
                                        as_uint8=True, cached=False).numpy()
  np.testing.assert_array_equal(quantized, images.to_uint8(chunked))


def test_cached_tree_launch_pattern(interp, monkeypatch):
  """One extraction per input frame and per non-leaf midpoint, at batch 1;
  one midpoint forward per output frame that is not an input."""
  calls = {'features': [], 'midpoints': 0}
  features, midpoint = (interp.features_device,
                        interp.midpoint_from_features_device)

  def count_features(x):
    calls['features'].append(int(x.shape[0]))
    return features(x)

  def count_midpoints(*args, **kwargs):
    calls['midpoints'] += 1
    return midpoint(*args, **kwargs)

  monkeypatch.setattr(interp, 'features_device', count_features)
  monkeypatch.setattr(interp, 'midpoint_from_features_device',
                      count_midpoints)
  interp.expand_tree_device(np.stack(_frames(3)), 3, cached=True)
  # 3 inputs + 2 pairs x 3 non-leaf midpoints; the leaves' extraction is
  # skipped inside the midpoint step.
  assert calls['features'] == [1, 1, 1]
  assert calls['midpoints'] == 14


@pytest.mark.parametrize('block', [(2, 2), (1, 2)])
def test_tiled_tree_matches_legacy_tiled_loop(tiny_state, monkeypatch, block):
  tiled = Interpolator(tiny_state, Options.tiny(), align=ALIGN,
                       block_shape=block, device='cpu')
  frames = _frames(3, 32, 48, seed=4)
  tree = recursion.interpolate_frontier(frames, 2, tiled)
  tree_u8 = tiled.expand_tree_device(np.stack(frames), 2,
                                     as_uint8=True).numpy()
  monkeypatch.setenv('FI_TREE_CACHED', '0')
  legacy = recursion.interpolate_frontier(frames, 2, tiled)
  assert len(tree) == len(legacy) == 9
  assert _max_abs(tree, legacy) <= NOISE_BOUND
  np.testing.assert_array_equal(tree_u8, images.to_uint8(np.stack(tree)))
  streamed = list(recursion.interpolate_frontier_streaming(
      frames, 2, tiled, pairs_per_chunk=1))
  assert _max_abs(streamed, legacy) == 0.0


@pytest.mark.parametrize('pairs_per_chunk,depth', [(1, 1), (1, 2), (2, 3),
                                                   (None, 2)])
def test_streaming_equals_frontier(interp, pairs_per_chunk, depth):
  frames = _frames(4, seed=5)
  want = recursion.interpolate_frontier(frames, 2, interp)
  produced = []
  got = list(recursion.interpolate_frontier_streaming(
      frames, 2, interp, pairs_per_chunk=pairs_per_chunk,
      pipeline_depth=depth, progress=produced.append))
  assert len(got) == len(want) == 13
  assert sum(produced) == recursion.num_interpolated_frames(4, 2)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)
  got_u8 = list(recursion.interpolate_frontier_streaming(
      frames, 2, interp, pairs_per_chunk=pairs_per_chunk,
      pipeline_depth=depth, as_uint8=True))
  np.testing.assert_array_equal(np.stack(got_u8),
                                images.to_uint8(np.stack(want)))


def test_paths_and_mixed_dtypes(interp, tmp_path):
  frames = _frames(3, seed=6)
  paths = []
  for i, frame in enumerate(frames):
    paths.append(str(tmp_path / f'frame_{i}.png'))
    images.write_image(paths[-1], frame)
  decoded = [images.read_image(p) for p in paths]
  bytes_ = [images.read_image_uint8(p) for p in paths]
  want = recursion.interpolate_frontier(decoded, 2, interp)
  # uint8 frames convert on the device exactly as read_image does.
  for got in (recursion.interpolate_frontier(bytes_, 2, interp),
              list(recursion.interpolate_frontier_streaming(
                  paths, 2, interp, pairs_per_chunk=1)),
              list(recursion.interpolate_frontier_streaming(
                  [bytes_[0], decoded[1], bytes_[2]], 2, interp,
                  pairs_per_chunk=1)),
              list(recursion.interpolate_recursively_cached(paths, 2,
                                                            interp))):
    assert len(got) == 9
    for a, b in zip(got, want):
      assert a.dtype == np.float32
      np.testing.assert_array_equal(a, b)
  from_files = list(recursion.interpolate_recursively_from_files(
      paths, 2, interp))
  assert _max_abs(from_files, want) <= NOISE_BOUND


def test_degenerate_inputs(interp):
  frames = _frames(2, seed=7)
  u8 = images.to_uint8(frames[0])
  assert recursion.interpolate_frontier([], 2, interp) == []
  assert list(recursion.interpolate_frontier_streaming([], 2, interp)) == []
  for driver in (recursion.interpolate_frontier,
                 lambda f, t, i: list(recursion.interpolate_frontier_streaming(
                     f, t, i)),
                 lambda f, t, i: list(recursion.interpolate_recursively_cached(
                     f, t, i))):
    one = driver([u8], 3, interp)
    assert len(one) == 1
    np.testing.assert_array_equal(one[0], u8.astype(np.float32) / 255.0)
    same = driver(frames, 0, interp)
    assert len(same) == 2
    for a, b in zip(same, frames):
      np.testing.assert_array_equal(a, b)
  for cached in (True, False):
    tree = interp.expand_tree_device(np.stack(frames), 0, cached=cached)
    np.testing.assert_array_equal(tree.numpy(), np.stack(frames))
    single = interp.expand_tree_device(np.stack(frames[:1]), 2,
                                       as_uint8=True, cached=cached)
    np.testing.assert_array_equal(single.numpy(),
                                  images.to_uint8(frames[0])[None])
  assert recursion.frontier_pairs_per_chunk(100, 2, 10_000) == 8
  assert recursion.frontier_pairs_per_chunk(100, 10, 10) == 1
