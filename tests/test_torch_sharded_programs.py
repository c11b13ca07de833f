"""The row-sharded pair as one program, on the CPU.

On a mesh that repeats one card, `SpatialShardedInterpolator` captures the
whole sharded forward as one CUDA graph: its shards' threads launch onto
the capturing stream, so nothing inside the forward may read the device on
the host, and the row-mode warp reads every shard's slab where it lies
(no reach, no halo-or-whole-frame branch). On the CPU the same forward
runs eagerly on `[cpu] * n`. Held here: the forward on 2 and 4 shards
against one device (1e-5) and JAX (>= 50 dB, test_torch_parallel.py's
bound); the sharded warp with flows on both sides of the JAX kernel's
reach bound (the 192 px halo: a small flow that stays within one slab and
a large one many slabs away) against the whole frame bit for bit and
JAX's warp; no `item`, `float`, `int` or `tolist` of a tensor inside the
forward; and the program's structure: one program a key entered once a
call, however many exchanges the shards make. Two JAX compiles.
"""
import threading

import numpy as np
import pytest
import torch

from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.ops import warp as jax_warp
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch import parallel
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.ops import rows, warp
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import inference as sharded
from frame_interpolation_tpu_torch.parallel import shard_map
from frame_interpolation_tpu_torch.utils import programs

torch.set_num_threads(2)

H, W = 64, 64


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def tiny_state():
  rng = np.random.RandomState(5)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in ** -0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


@pytest.fixture(scope='module')
def pair(tiny_state):
  rng = np.random.RandomState(6)
  x0, x1 = (rng.rand(1, H, W, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  one = Interpolator(tiny_state, Options.tiny(), align=16, device='cpu')(
      x0, x1, dt)
  # One JAX compile.
  jax_out = jax_interp.Interpolator(params_io.to_flax_params(tiny_state),
                                    JaxOptions.tiny(), align=16)(x0, x1, dt)
  return (x0, x1, dt), one, np.asarray(jax_out)


def _no_host_read(*args):
  raise AssertionError('the row-sharded forward read a tensor on the host')


@pytest.mark.parametrize('n', [2, 4])
def test_row_sharded_forward_matches_one_device_and_jax(tiny_state, pair, n,
                                                        monkeypatch):
  (x0, x1, dt), one, want = pair
  interp = parallel.SpatialShardedInterpolator(tiny_state, Options.tiny(),
                                               parallel.Mesh(['cpu'] * n),
                                               align=16)
  assert interp.program is None  # the CPU runs the forward eagerly
  frames = [interp.to_device(a) for a in (x0, x1, dt)]
  with monkeypatch.context() as m:
    for name in ('item', '__float__', '__int__', 'tolist'):
      m.setattr(torch.Tensor, name, _no_host_read)
    got = interp.call_device(*frames)
  got = got.numpy()
  assert got.shape == one.shape
  assert float(np.abs(got - one).max()) <= 1e-5
  assert _psnr(got, want) >= 50.0


def _flow(seed, max_dy, h=H, w=W):
  rng = np.random.RandomState(seed)
  flow = (rng.rand(2, h, w, 2) * 2 - 1).astype(np.float32)
  flow[..., 0] *= 20.0
  flow[..., 1] *= max_dy
  return flow


def test_sharded_warp_on_both_sides_of_the_reach_bound():
  # 16-row slabs on 4 shards: the JAX kernel's halo of k slabs holds
  # |dy| <= 16k - 1 and falls back to the whole frame past it. The small
  # flow stays inside one slab; the large one reaches the whole frame.
  rng = np.random.RandomState(7)
  image = rng.rand(2, H, W, 5).astype(np.float32)
  flows = {'small': _flow(8, 15.0), 'large': _flow(9, 3.0 * H)}
  # One JAX compile: the whole-frame warp, for both flows.
  want = {k: np.asarray(jax_warp.backward_warp(image, f))
          for k, f in flows.items()}
  x = torch.from_numpy(image)
  for n in (2, 4):
    collective = shard_map.Collective(n, timeout=60)
    for kind, flow in flows.items():
      f = torch.from_numpy(flow)
      whole = warp.backward_warp(x, f)

      def shard(index):
        row_shard = rows.RowShard(collective, index, H, W)
        with rows.sharding(row_shard):
          return warp.backward_warp(row_shard.take(x), row_shard.take(f))

      outs = shard_map.run_shards(shard, [torch.device('cpu')] * n,
                                  collective)
      got = torch.cat(outs, dim=1)
      assert torch.equal(got, whole), (n, kind)
      np.testing.assert_allclose(got.numpy(), want[kind], rtol=0, atol=1e-5)


class _Program:
  """Stands in for utils/programs.Program: runs the function eagerly and
  records each call's key."""
  made = []

  def __init__(self, fn, device, name, pool=None):
    self.fn, self.name, self.keys = fn, name, []
    _Program.made.append(self)

  def __call__(self, *args, **static):
    self.keys.append(programs.signature(args))
    return self.fn(*args, **static)


def test_one_program_a_key_entered_once_a_call(tiny_state, pair,
                                               monkeypatch):
  # The design's prediction: however many exchanges the shards make, the
  # whole sharded pair is one program (on the card, one graph a key and
  # one replay a call).
  (x0, x1, dt), one, _ = pair
  _Program.made.clear()
  monkeypatch.setattr(programs, 'Program', _Program)
  # As on a card: None resolves to programs, False stays eager.
  monkeypatch.setattr(programs, 'resolve',
                      lambda graphs, device, what: graphs is not False)
  exchanges = []
  lock = threading.Lock()
  exchange = shard_map.Collective.exchange

  def counted(self, index, value):
    with lock:
      exchanges.append(index)
    return exchange(self, index, value)

  monkeypatch.setattr(shard_map.Collective, 'exchange', counted)
  interp = sharded.SpatialShardedInterpolator(
      tiny_state, Options.tiny(), parallel.Mesh(['cpu'] * 4), align=16)
  program, = _Program.made
  assert interp.program is program and program.name == 'row_pair'
  got = interp(x0, x1, dt)
  interp(x0[:, :48], x1[:, :48], dt)
  assert float(np.abs(got - one).max()) <= 1e-5
  assert len(program.keys) == 2 and program.keys[0] != program.keys[1]
  # Many exchanges a shard a call, none of them a boundary of the program.
  per_shard = exchanges.count(0)
  assert per_shard > 20 and all(exchanges.count(i) == per_shard
                                for i in range(4))


def test_graphs_true_needs_one_cuda_device(tiny_state):
  mesh = parallel.Mesh(['cpu'] * 2)
  with pytest.raises(ValueError, match='graphs=True needs a CUDA device'):
    parallel.SpatialShardedInterpolator(tiny_state, Options.tiny(), mesh,
                                        align=16, graphs=True)
  assert parallel.SpatialShardedInterpolator(
      tiny_state, Options.tiny(), mesh, align=16, graphs=None).program is None
