"""The train cell in the benchmark: its entries in BENCHMARK.json, the
reader of its step's graph replays on small synthetic traces, and the
TF32 convs its reference runs on the card, here on the CPU."""
import types

import pytest
import torch
import torch.nn.functional as F

from film_bench import bench
from film_bench import trace as trace_lib
from film_bench.reference import tf32_convs

CELL = 'train-style-256'
READERS = ('idle_share.train', 'mfu.train', 'splat_roofline.train',
           'graph_hits.train')


def test_the_benchmark_lists_the_train_cell():
  spec = bench.benchmark()
  cell = {w['name']: w for w in spec['workloads']}[CELL]
  assert (cell['config'], cell['traffic'], cell['chips']) == (
      'film_net-Style-f32', CELL, 1)
  config = {c['name']: c for c in spec['configs']}['film_net-Style-f32']
  assert config['reduced'] == []
  assert config['source'] == bench.load_json('configs',
                                             'film_net-Style-f32')['source']
  rate = {m['name']: m for m in spec['end_to_end']}['train_steps_per_s']
  assert (rate['unit'], rate['better'], rate['workloads']) == (
      'steps/s', 'higher', [CELL])
  assert 0.01 <= rate['bound'] <= 0.25
  listed = {m['name']: m for m in spec['per_layer']}
  for name in READERS:
    assert listed[name]['workloads'] == [CELL]
    assert listed[name]['moves'] == 'train_steps_per_s'
    assert callable(bench.load_reader(name).read)


def _annotation(name, start, dur):
  return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': start,
          'dur': dur}


def _steps(replays, captures=0, marked=True):
  """A 100 ms window of 10 ms steps: the first `captures` capture the
  step, the next `replays` replay it."""
  events = [_annotation('film_bench.window', 0, 100_000)]
  for i in range(captures + replays):
    events.append(_annotation('film_bench.step', i * 10_000, 9_000))
    if marked:
      events.append(_annotation('fi.train.step', i * 10_000 + 10, 8_900))
      kind = 'capture' if i < captures else 'replay'
      events.append(_annotation(f'fi.{kind}.train_step', i * 10_000 + 20,
                                8_000))
  return trace_lib.Trace(events)


def _graph_hits(trace):
  ctx = types.SimpleNamespace(workload=bench.load_json('workloads', CELL))
  return bench.load_reader('graph_hits.train').read(trace, {}, ctx)


@pytest.mark.parametrize('replays, captures, want', [
    (9, 0, 100.0), (8, 1, 100 * 8 / 9), (0, 2, 0.0)])
def test_graph_hits_train_reads_the_replays(replays, captures, want):
  assert _graph_hits(_steps(replays, captures)) == pytest.approx(want)


@pytest.mark.parametrize('marked', [True, False])
def test_graph_hits_train_reads_nothing_without_programs(marked):
  """Steps that neither replay nor capture (the eager path), or a program
  without spans: nothing to read."""
  trace = _steps(4, marked=False)
  if marked:
    trace = trace_lib.Trace(
        [_annotation('film_bench.window', 0, 100_000),
         _annotation('fi.train.step', 10, 8_000)])
  assert _graph_hits(trace) is None


def test_tf32_convs_hand_every_conv_channels_last_operands():
  x, w = torch.ones(2, 5, 9, 11), torch.ones(7, 5, 3, 3)
  bias = torch.ones(7)
  out = tf32_convs.channels_last([x, w, bias, [1, 1], False])
  assert out[0].is_contiguous(memory_format=torch.channels_last)
  assert out[1].is_contiguous(memory_format=torch.channels_last)
  assert out[2] is bias and out[3:] == [[1, 1], False]


def test_tf32_convs_compute_the_conv():
  """On the CPU, which has no TF32, the convs inside give the plain conv's
  forward and gradients (a channels_last layout sums in another order)."""
  g = torch.Generator().manual_seed(5)
  x, w = torch.randn(2, 5, 9, 11, generator=g), torch.randn(7, 5, 3, 3,
                                                             generator=g)
  b = torch.randn(7, generator=g)

  def step():
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = F.conv2d(*leaves, padding=1)
    (y * y).sum().backward()
    return [y.detach()] + [t.grad for t in leaves]

  with tf32_convs.TF32Convs():
    got = step()
  for a, c in zip(got, step()):
    assert torch.allclose(a, c, rtol=1e-5, atol=1e-4)


def test_tf32_convs_leave_the_switches_as_they_were():
  before = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
  with tf32_convs.TF32Convs():
    F.conv2d(torch.ones(1, 2, 4, 4), torch.ones(3, 2, 3, 3))
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
  assert (torch.backends.cudnn.allow_tf32,
          torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize('device, allow, quant, tf32_mode', [
    ('cuda', True, None, True), ('cuda', False, None, False),
    ('cuda', True, 'bfloat16', False), ('cpu', True, None, False)])
def test_the_train_reference_takes_tf32_where_the_program_does(
    device, allow, quant, tf32_mode):
  driver_cls = bench.load_driver('train_step').Driver
  driver = driver_cls.__new__(driver_cls)
  driver.ctx = types.SimpleNamespace(config={'cudnn_allow_tf32': allow},
                                     device=torch.device(device))
  convs = driver._convs(quant)
  assert isinstance(convs, tf32_convs.TF32Convs) == tf32_mode
