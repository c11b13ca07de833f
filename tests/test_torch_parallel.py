"""The port's sharded serving on a mesh of CPU shards.

SpatialShardedInterpolator (rows), ShardedInterpolator (patches) and
ShardedVideoInterpolator (frame-tree nodes) run on `[cpu] * n` meshes, as
the JAX tests run on a virtual 8-device CPU mesh, and are held against
the port's single-device Interpolator (and once against the JAX
package's); the CLIs' --mesh paths, the mesh and collective helpers, a
failing shard, and the state the shards share (the kernels' build, their
launch counts, the packed conv weights).
"""
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch import parallel
from frame_interpolation_tpu_torch.cli import interpolate_dir, interpolate_pair
from frame_interpolation_tpu_torch.inference import Interpolator, recursion
from frame_interpolation_tpu_torch.inference import interpolator
from frame_interpolation_tpu_torch.io import images, params_io
from frame_interpolation_tpu_torch.models import film_net, fusion
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack, conv_weights
from frame_interpolation_tpu_torch.ops import rows
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import mesh as mesh_lib
from frame_interpolation_tpu_torch.parallel import shard_map

torch.set_num_threads(2)


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def tiny_state():
  rng = np.random.RandomState(1)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in ** -0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


def _mesh(n):
  return parallel.Mesh(['cpu'] * n)


def _pair(h, w, seed=2, batch=1):
  rng = np.random.RandomState(seed)
  return (rng.rand(batch, h, w, 3).astype(np.float32),
          rng.rand(batch, h, w, 3).astype(np.float32),
          np.full((batch,), 0.5, np.float32))


# ---- SpatialShardedInterpolator ---------------------------------------------


@pytest.mark.parametrize('n', [1, 2, 4])
@pytest.mark.parametrize('h,w', [(64, 96), (48, 80), (37, 53), (100, 40)])
def test_spatial_sharded_matches_one_device(tiny_state, n, h, w):
  # Padded to 16: 64 rows split at every level over 4 shards; 48 splits
  # its two finest levels (slabs 12, 6) and gathers below; 112 rows over 4
  # (slabs of 28, 14, 7) split two levels, over 2 three.
  x0, x1, dt = _pair(h, w, batch=2 if h == 48 else 1)
  want = Interpolator(tiny_state, Options.tiny(), align=16, device='cpu')(
      x0, x1, dt)
  got = parallel.SpatialShardedInterpolator(
      tiny_state, Options.tiny(), _mesh(n), align=16)(x0, x1, dt)
  assert got.shape == want.shape
  assert float(np.abs(got - want).max()) <= 1e-5


def test_spatial_sharded_matches_jax(tiny_state):
  x0, x1, dt = _pair(64, 64, seed=3)
  want = jax_interp.Interpolator(params_io.to_flax_params(tiny_state),
                                 JaxOptions.tiny(), align=16)(x0, x1, dt)
  got = parallel.SpatialShardedInterpolator(
      tiny_state, Options.tiny(), _mesh(4), align=16)(x0, x1, dt)
  assert _psnr(got, want) >= 50.0
  assert float(np.abs(got - want).max()) <= 1e-4


def test_spatial_sharded_runs_the_row_paths(tiny_state, monkeypatch):
  # 64 rows over 4 shards: every level splits, so each shard's warps take
  # the row mode and its extractor stacks the 2-row halo.
  from frame_interpolation_tpu_torch.ops import warp
  counts = {'warp_rows': 0, 'stack_rows': 0}
  lock = threading.Lock()

  def counted(name, fn):
    def wrapper(*args, **kwargs):
      with lock:
        counts[name] += 1
      return fn(*args, **kwargs)
    return wrapper

  monkeypatch.setattr(warp, 'backward_warp_rows',
                      counted('warp_rows', warp.backward_warp_rows))
  monkeypatch.setattr(conv_stack, 'stack_rows',
                      counted('stack_rows', conv_stack.stack_rows))
  x0, x1, dt = _pair(64, 64)
  parallel.SpatialShardedInterpolator(tiny_state, Options.tiny(), _mesh(4),
                                      align=16)(x0, x1, dt)
  options = Options.tiny()
  # Per shard: flow warps at levels 0..L-2 in two directions, fusion warps
  # at its levels in two; each frame's extractor runs one stack per
  # (image level, sub-level) pair that exists.
  warps = 2 * (options.pyramid_levels - 1) + 2 * options.fusion_pyramid_levels
  stacks = 2 * sum(min(options.pyramid_levels - i, options.sub_levels)
                   for i in range(options.pyramid_levels))
  assert counts == {'warp_rows': 4 * warps, 'stack_rows': 4 * stacks}


def test_a_failing_shard_fails_the_call_without_waiting(tiny_state,
                                                        monkeypatch):
  # The others stop at their next exchange, long before the barrier's
  # timeout.
  halo = rows.RowShard.halo

  def failing_halo(self, x, *args, **kwargs):
    if self.index == 1:
      raise RuntimeError('shard 1 failed')
    return halo(self, x, *args, **kwargs)

  x0, x1, dt = _pair(64, 64)
  interp = parallel.SpatialShardedInterpolator(tiny_state, Options.tiny(),
                                               _mesh(4), align=16)
  want = interp(x0, x1, dt)
  monkeypatch.setattr(rows.RowShard, 'halo', failing_halo)
  start = time.monotonic()
  with pytest.raises(RuntimeError, match='shard 1 failed'):
    interp(x0, x1, dt)
  assert time.monotonic() - start < 30.0
  # The shards' threads outlive the failure and serve the next call.
  monkeypatch.undo()
  np.testing.assert_array_equal(interp(x0, x1, dt), want)


def test_shard_threads_last_as_long_as_their_pool():
  # PyTorch keeps some caches per thread (cuDNN's plans): each call runs
  # shard i on the same thread i.
  pool = shard_map.ShardPool([torch.device('cpu')] * 3)
  first = pool.run(lambda i: threading.get_ident())
  assert pool.run(lambda i: threading.get_ident()) == first
  assert len(set(first)) == 3 and threading.get_ident() not in first
  threads = [t for t in threading.enumerate() if t.ident in first]
  pool.close()
  for t in threads:
    t.join(timeout=10)
  assert not any(t.is_alive() for t in threads)
  # A pool that is dropped ends its threads too.
  pool = shard_map.ShardPool([torch.device('cpu')] * 2)
  idents = pool.run(lambda i: threading.get_ident())
  threads = [t for t in threading.enumerate() if t.ident in idents]
  del pool
  for t in threads:
    t.join(timeout=10)
  assert not any(t.is_alive() for t in threads)


def test_a_shard_that_never_arrives_times_out():
  collective = shard_map.Collective(3, timeout=0.5)

  def run(index):
    if index == 2:
      return 'left early'
    return collective.exchange(index, index)

  start = time.monotonic()
  with pytest.raises(shard_map.ShardAborted):
    shard_map.run_shards(run, [torch.device('cpu')] * 3, collective)
  assert time.monotonic() - start < 10.0


# ---- ShardedInterpolator and ShardedVideoInterpolator ------------------------


@pytest.mark.parametrize('n,block', [(3, (2, 2)), (2, (1, 3)), (4, (2, 2))])
def test_sharded_patches_match_the_tiled_pair(tiny_state, n, block):
  # 4 patches over 3 shards and 3 over 2: padded with copies of the last.
  x0, x1, dt = _pair(64, 96, seed=4)
  want = Interpolator(tiny_state, Options.tiny(), align=16, block_shape=block,
                      device='cpu')(x0, x1, dt)
  got = parallel.ShardedInterpolator(tiny_state, Options.tiny(), _mesh(n),
                                     block_shape=block, align=16)(x0, x1, dt)
  assert got.shape == want.shape == (1, 64, 96, 3)
  assert float(np.abs(got - want).max()) <= 1e-5


@pytest.mark.parametrize('n,frames,times,max_batch', [
    (2, 3, 2, None), (3, 3, 2, 4), (4, 2, 3, 1)])
def test_sharded_video_matches_the_chunked_tree(tiny_state, n, frames, times,
                                                max_batch):
  rng = np.random.RandomState(5)
  video = (rng.rand(frames, 24, 40, 3) * 255).astype(np.uint8)
  single = Interpolator(tiny_state, Options.tiny(), align=8, device='cpu')
  want = interpolator.expand_tree_chunked(
      single.to_device(video), times, 3, False,
      single.interpolate_device).numpy()
  sharded = parallel.ShardedVideoInterpolator(tiny_state, Options.tiny(),
                                              _mesh(n), align=8)
  got = sharded.expand_tree_device(video, times, max_batch=max_batch)
  assert got.shape == want.shape == ((frames - 1) * 2**times + 1, 24, 40, 3)
  assert float(np.abs(got.numpy() - want).max()) <= 1e-5
  as_u8 = sharded.expand_tree_device(video, times, as_uint8=True)
  np.testing.assert_array_equal(as_u8.numpy(), images.to_uint8(got.numpy()))
  # A drop-in for the frontier drivers.
  streamed = list(recursion.interpolate_frontier_streaming(
      list(video), times, sharded, pairs_per_chunk=1))
  assert float(np.abs(np.stack(streamed) - want).max()) <= 1e-5


# ---- the CLIs ----------------------------------------------------------------


def _write_pair(tmp_path, h, w):
  rng = np.random.RandomState(6)
  paths = []
  for name in ('one.png', 'two.png'):
    path = str(tmp_path / name)
    images.write_image(path, rng.rand(h, w, 3).astype(np.float32))
    paths.append(path)
  return paths


@pytest.fixture(scope='module')
def bundle(tiny_state, tmp_path_factory):
  path = str(tmp_path_factory.mktemp('bundle'))
  params_io.save_state_bundle(path, tiny_state, Options.tiny())
  return path


@pytest.mark.parametrize('mesh,block', [('spatial', 1), ('data', 2)])
def test_interpolate_pair_mesh_over_a_cpu_mesh(bundle, tmp_path, monkeypatch,
                                               caplog, mesh, block):
  frame1, frame2 = _write_pair(tmp_path, 48, 64)
  args = ['--frame1', frame1, '--frame2', frame2, '--params', bundle,
          '--align', '16', '--block_height', str(block), '--block_width',
          str(block), '--device', 'cpu']
  interpolate_pair.main(args + ['--output_frame',
                                str(tmp_path / 'single.png')])
  monkeypatch.setattr(mesh_lib, 'visible_devices',
                      lambda device: [torch.device('cpu')] * 4)
  with caplog.at_level(logging.INFO):
    interpolate_pair.main(args + ['--mesh', mesh, '--output_frame',
                                  str(tmp_path / 'mesh.png')])
  assert f'--mesh {mesh} over Mesh(data: cpu, cpu, cpu, cpu)' in caplog.text
  # Equal to float noise, so a byte may round the other way.
  got = images.read_image_uint8(str(tmp_path / 'mesh.png')).astype(int)
  want = images.read_image_uint8(str(tmp_path / 'single.png')).astype(int)
  assert np.abs(got - want).max() <= 1


def test_one_visible_device_serves_unsharded(bundle, tmp_path, caplog):
  frame1, frame2 = _write_pair(tmp_path, 16, 16)
  with caplog.at_level(logging.INFO):
    interpolate_pair.main(['--frame1', frame1, '--frame2', frame2,
                           '--params', bundle, '--align', '16', '--mesh',
                           'spatial', '--device', 'cpu', '--output_frame',
                           str(tmp_path / 'mid.png')])
  assert 'only one device is visible; running single-device' in caplog.text
  assert images.read_image(str(tmp_path / 'mid.png')).shape == (16, 16, 3)


def test_interpolate_dir_mesh_data_over_a_cpu_mesh(bundle, tmp_path,
                                                   monkeypatch):
  rng = np.random.RandomState(7)
  clip = tmp_path / 'clips' / 'a'
  clip.mkdir(parents=True)
  for index in (1, 2, 3):
    images.write_image(str(clip / f'frame_{index}.png'),
                       rng.rand(24, 40, 3).astype(np.float32))
  args = ['--pattern', str(tmp_path / 'clips' / '*'), '--params', bundle,
          '--times_to_interpolate', '2', '--align', '8', '--device', 'cpu']
  interpolate_dir.main(args)
  out = clip / 'interpolated_frames'
  want = [images.read_image_uint8(str(p)) for p in sorted(out.iterdir())]
  monkeypatch.setattr(mesh_lib, 'visible_devices',
                      lambda device: [torch.device('cpu')] * 2)
  interpolate_dir.main(args + ['--mesh', 'data'])
  got = [images.read_image_uint8(str(p)) for p in sorted(out.iterdir())]
  assert len(got) == len(want) == 9
  for a, b in zip(got, want):
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
  for extra in (['--streaming'], ['--block_height', '2']):
    with pytest.raises(SystemExit):
      interpolate_dir.main(args + ['--mesh', 'data'] + extra)


# ---- the mesh and the collective ---------------------------------------------


def test_mesh_replicate_and_shard_batch(tiny_state):
  mesh = parallel.create_mesh(['cpu', 'cpu', 'cpu'])
  assert mesh.size == 3 and repr(mesh) == 'Mesh(data: cpu, cpu, cpu)'
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(tiny_state)
  replicas = parallel.replicate(model, mesh)
  # One copy for the one distinct device, shared by its three shards.
  assert replicas[0] is replicas[1] is replicas[2] and replicas[0] is not model
  assert all(torch.equal(a, b) for a, b in zip(
      replicas[0].state_dict().values(), model.state_dict().values()))
  parts = parallel.shard_batch(torch.arange(6).reshape(6, 1), mesh)
  assert [p.tolist() for p in parts] == [[[0], [1]], [[2], [3]], [[4], [5]]]
  with pytest.raises(ValueError, match='does not divide'):
    parallel.shard_batch(torch.zeros(4, 1), mesh)
  with pytest.raises(ValueError, match='at least one device'):
    parallel.Mesh([])
  assert mesh_lib.visible_devices('cpu') == [torch.device('cpu')]


def test_collective_exchange_gather_pmax_and_halos():
  n = 4
  collective = shard_map.Collective(n, timeout=60)
  frame = torch.arange(2 * 16 * 3 * 1, dtype=torch.float32).reshape(
      2, 16, 3, 1)

  def run(index):
    shard = rows.RowShard(collective, index, 16, 3)
    slab = shard.take(frame)
    values = shard.exchange(index * 10)
    gathered = shard.gather(slab)
    zeros = shard.halo(slab, 6, 5)
    clamp = shard.halo(slab, 1, 1, edge='clamp')
    return values, gathered, zeros, clamp

  padded = torch.cat([torch.zeros(2, 6, 3, 1), frame,
                      torch.zeros(2, 5, 3, 1)], dim=1)
  edged = torch.cat([frame[:, :1], frame, frame[:, -1:]], dim=1)
  for index, (values, gathered, zeros, clamp) in enumerate(
      shard_map.run_shards(run, [torch.device('cpu')] * n, collective)):
    assert values == [0, 10, 20, 30]
    assert torch.equal(gathered, frame)
    # 6 rows above take a whole slab and part of the next: zeros past row 0.
    assert torch.equal(zeros, padded[:, 4 * index:4 * index + 15])
    assert torch.equal(clamp, edged[:, 4 * index:4 * index + 6])


def test_row_shard_levels_split_as_the_gate_says():
  shard = rows.RowShard(shard_map.Collective(4), 0, 1088, 1920)
  split = [shard.split_width(1920 >> i) for i in range(7)]
  # 1088 rows over 4: slabs 272, 136, 68, 34 split; 68 rows -> 17 do not.
  assert split == [True, True, True, True, False, False, False]
  shard2 = rows.RowShard(shard_map.Collective(2), 1, 1088, 1920)
  assert [shard2.split_width(1920 >> i) for i in range(7)] == (
      [True] * 5 + [False] * 2)
  with pytest.raises(ValueError, match='no pyramid level'):
    shard.split_width(1000)


# ---- the state the shards share ----------------------------------------------


@pytest.fixture
def fast_switching():
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    yield
  finally:
    sys.setswitchinterval(interval)


def _in_threads(fn, count=16):
  threads = [threading.Thread(target=fn) for _ in range(count)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  assert not any(t.is_alive() for t in threads)


def test_launch_counts_lose_nothing_across_threads(monkeypatch,
                                                   fast_switching):
  monkeypatch.setattr(_kernels, 'LAUNCHES', dict(_kernels.LAUNCHES))
  _kernels.reset_launch_counts()

  def count():
    for _ in range(2000):
      _kernels.count_launch('warp_rows')
      _kernels.count_launch('conv3x3_c64')

  _in_threads(count)
  counts = _kernels.launch_counts()
  assert counts['warp_rows'] == counts['conv3x3_c64'] == 16 * 2000


def test_library_builds_once_across_threads(monkeypatch, fast_switching):
  builds = []

  def build():
    builds.append(threading.get_ident())
    time.sleep(0.05)
    return 'libfake.so'

  class FakeCtypes:
    CDLL = staticmethod(lambda path: ('loaded', path))

  monkeypatch.setattr(_kernels, '_lib', None)
  monkeypatch.setattr(_kernels, '_build', build)
  monkeypatch.setattr(_kernels, '_declare', lambda lib: None)
  monkeypatch.setattr(_kernels, 'ctypes', FakeCtypes)
  loaded = []
  _in_threads(lambda: loaded.append(_kernels.library()), count=8)
  assert len(builds) == 1 and loaded == [('loaded', 'libfake.so')] * 8


def _packed_copy():
  # The kernels' packed copy of a conv weight.
  weight = torch.randn(8, 4, 3, 3)
  return conv_weights, '_pack', lambda: conv_weights.packed(
      weight, torch.float32, 'f32')


def _gathered_copy():
  # The fusion's gathered copy of conv_0_1's weight.
  model = film_net.create_model(Options.tiny())
  order = model.fusion._packed_orders['conv_0_1']
  return fusion, '_gather', lambda: fusion.gathered(
      model.fusion.conv_0_1, order, (len(order),))


@pytest.mark.parametrize('copy', [_packed_copy, _gathered_copy],
                         ids=['packed', 'gathered'])
def test_packed_weights_pack_once_across_threads(monkeypatch, fast_switching,
                                                 copy):
  module, maker, take = copy()
  packs = []
  make = getattr(module, maker)

  def counted(*args):
    packs.append(1)
    time.sleep(0.01)
    return make(*args)

  monkeypatch.setattr(module, maker, counted)
  got = []
  _in_threads(lambda: got.append(take()))
  assert len(packs) == 1 and all(g is got[0] for g in got)
