"""The port's spans (utils/profiling.span) on the CPU.

With no profiler running a span is one flag read and a shared null
context, on every thread; under torch.profiler it is a `record_function`
range in the trace. The Interpolator marks each crossing to the device
(`fi.upload`) and each numpy result of a pair (`fi.download`); a program
marks its replays and captures (`fi.replay.<name>`, `fi.capture.<name>`);
the streaming recursion its chunks (`fi.chunk`) and fetch waits
(`fi.fetch_wait`), none of them open while the caller holds a frame; the
pair and directory CLIs write a trace of them with `--profile_dir`. No JAX.
"""
import contextlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from frame_interpolation_tpu_torch.cli import interpolate_dir, interpolate_pair
from frame_interpolation_tpu_torch.inference import Interpolator, recursion
from frame_interpolation_tpu_torch.io import images
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.utils import profiling, programs

torch.set_num_threads(2)


def _on(where, fn):
  """fn() on this thread or on a second one; its result."""
  if where == 'main_thread':
    return fn()
  out = []
  worker = threading.Thread(target=lambda: out.append(fn()))
  worker.start()
  worker.join()
  return out[0]


def _spans(path, name=None, prefix=None, cat='user_annotation'):
  """(start, end) of the trace's host annotations (or other host events
  of `cat`) named `name`, or starting with `prefix`, in start order."""
  with open(path) as f:
    events = json.load(f)['traceEvents']
  return sorted((e['ts'], e['ts'] + e['dur']) for e in events
                if e.get('cat') == cat and 'dur' in e and (
                    e.get('name') == name if prefix is None
                    else e.get('name', '').startswith(prefix)))


def _inside(inner, outer):
  return outer[0] <= inner[0] and inner[1] <= outer[1]


def _overlap(a, b):
  return a[0] < b[1] and b[0] < a[1]


@pytest.mark.parametrize('where', ['main_thread', 'second_thread'])
def test_span_without_a_profiler_is_one_check_and_a_shared_null(where,
                                                                monkeypatch):
  def refuse(name):
    raise AssertionError(f'record_function({name!r}) with no profiler')

  monkeypatch.setattr(torch.profiler, 'record_function', refuse)
  monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
  reads = []

  class Flag:
    @property
    def _is_profiler_enabled(self):
      reads.append(1)
      return False

  monkeypatch.setattr(profiling, '_profiler_state', Flag())

  def look():
    made = [profiling.span(f'fi.{i}') for i in range(5)]
    for span in made:
      with span:
        pass
    return made

  made = _on(where, look)
  assert all(span is made[0] for span in made)
  assert isinstance(made[0], contextlib.nullcontext)
  assert len(reads) == 5  # one flag read a span, nothing else


@pytest.mark.parametrize('where', ['main_thread', 'second_thread'])
def test_span_under_a_profiler_is_a_record_function_on_every_thread(where):
  # The sharded classes launch from threads of their own: the check reads
  # the same on every thread.
  assert isinstance(profiling.span('fi.x'), contextlib.nullcontext)
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU]):
    span = _on(where, lambda: profiling.span('fi.x'))
  assert isinstance(span, torch.autograd.profiler.record_function)
  assert isinstance(profiling.span('fi.x'), contextlib.nullcontext)


@pytest.fixture(scope='module')
def interp():
  options = Options.tiny()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(0))
  return Interpolator(model, options, align=16, device='cpu')


def _pair(h=24, w=40, seed=0):
  rng = np.random.RandomState(seed)
  return [rng.randint(0, 256, (1, h, w, 3), dtype=np.uint8)
          for _ in range(2)]


@pytest.mark.parametrize('call', ['__call__', 'interpolate'])
def test_a_pair_marks_its_uploads_and_its_download(interp, call, tmp_path):
  x0, x1 = _pair()
  dt = np.full((1,), 0.5, np.float32)
  trace = profiling.Trace(str(tmp_path))
  with torch.profiler.record_function('caller'):
    out = getattr(interp, call)(x0, x1, dt)
  path = trace.stop()
  assert out.shape == (1, 24, 40, 3) and isinstance(out, np.ndarray)
  (caller,) = _spans(path, 'caller')
  uploads = _spans(path, 'fi.upload')
  downloads = _spans(path, 'fi.download')
  assert len(uploads) == 3 and len(downloads) == 1  # x0, x1, dt; the result
  assert all(_inside(s, caller) for s in uploads + downloads)
  assert downloads[0][0] >= uploads[-1][1]


def test_only_a_crossing_is_an_upload(interp, tmp_path):
  x0, _ = _pair()
  trace = profiling.Trace(str(tmp_path))
  on_device = interp.to_device(x0)
  same = interp.to_device(on_device)
  interp.features_device(on_device)
  path = trace.stop()
  assert len(_spans(path, 'fi.upload')) == 1
  np.testing.assert_array_equal(same.numpy(), on_device.numpy())


class _Stream:
  """What a replay calls of the current stream and the pool's event."""

  def wait_event(self, event):
    pass

  def record(self, stream=None):
    pass


@pytest.fixture
def cpu_program(monkeypatch):
  """A Program made as on a card, its CUDA calls stubbed."""
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda device: types.SimpleNamespace(
                          total_memory=80 << 30))
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda device: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda device=None: _Stream())
  return programs.Program(lambda x: x * 2, 'cuda:0', 'pair')


def test_a_replay_and_a_capture_are_one_span_each(cpu_program, tmp_path):
  replays = []
  capture = programs.Capture(
      graph=types.SimpleNamespace(replay=lambda: replays.append(1)),
      inputs=[torch.zeros(3)], outputs=torch.full((3,), 7.0), launches={},
      capture_seconds=0.0, pool_bytes=0)
  cpu_program.pool.done = _Stream()

  def no_room(budget):
    raise RuntimeError('room made')

  cpu_program.pool.make_room = no_room
  trace = profiling.Trace(str(tmp_path))
  out = cpu_program._replay(capture, (torch.ones(3),))
  with pytest.raises(RuntimeError, match='room made'):
    cpu_program(torch.ones(3))  # a key it has not seen: a first call
  path = trace.stop()
  assert replays == [1] and torch.equal(out, torch.full((3,), 7.0))
  assert torch.equal(capture.inputs[0], torch.ones(3))
  (replay,) = _spans(path, 'fi.replay.pair')
  # The copy into the static buffers and the output's clone are the
  # replay's.
  for op in ('aten::copy_', 'aten::clone'):
    assert any(_inside(s, replay) for s in _spans(path, op, cat='cpu_op'))
  assert len(_spans(path, 'fi.capture.pair')) == 1
  assert _spans(path, prefix='fi.') == sorted(
      _spans(path, 'fi.replay.pair') + _spans(path, 'fi.capture.pair'))


def _clip(n=4, h=24, w=40, seed=3):
  rng = np.random.RandomState(seed)
  return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize('depth', [1, 2])
def test_streaming_spans_leave_the_consumer_out(interp, depth, tmp_path):
  clip = _clip()
  trace = profiling.Trace(str(tmp_path))
  frames = []
  stream = recursion.interpolate_frontier_streaming(
      clip, 1, interp, pairs_per_chunk=1, as_uint8=True,
      pipeline_depth=depth)
  for frame in stream:
    with torch.profiler.record_function('consumer'):
      frames.append(frame)
      time.sleep(0.02)
  path = trace.stop()
  assert len(frames) == 7
  chunks = _spans(path, 'fi.chunk')
  waits = _spans(path, 'fi.fetch_wait')
  consumer = _spans(path, 'consumer')
  assert len(chunks) == 3 and len(waits) == 3 and len(consumer) == 7
  assert not any(_overlap(c, s) for c in consumer for s in chunks + waits)
  # Each chunk holds its upload.
  uploads = _spans(path, 'fi.upload')
  assert len(uploads) == 3
  assert all(_inside(u, c) for u, c in zip(uploads, chunks))


def _write_frames(directory, count, h=64, w=96, seed=4):
  os.makedirs(directory, exist_ok=True)
  rng = np.random.RandomState(seed)
  paths = []
  for i in range(count):
    path = os.path.join(directory, f'frame_{i}.png')
    images.write_image(path, rng.rand(h, w, 3).astype(np.float32))
    paths.append(path)
  return paths


@pytest.mark.parametrize('cli, names', [
    ('interpolate_pair', ('fi.upload', 'fi.download')),
    ('interpolate_dir', ('fi.upload', 'fi.chunk', 'fi.fetch_wait'))])
def test_the_clis_write_a_trace_of_the_spans(cli, names, tmp_path):
  prof = str(tmp_path / 'prof')
  if cli == 'interpolate_pair':
    frame1, frame2 = _write_frames(str(tmp_path), 2)
    interpolate_pair.main(['--frame1', frame1, '--frame2', frame2,
                           '--params', 'random', '--output_frame',
                           str(tmp_path / 'mid.png'), '--device', 'cpu',
                           '--profile_dir', prof])
  else:
    _write_frames(str(tmp_path / 'clips' / 'a'), 2)
    interpolate_dir.main(['--pattern', str(tmp_path / 'clips' / '*'),
                          '--params', 'random', '--times_to_interpolate',
                          '1', '--device', 'cpu', '--profile_dir', prof])
  assert os.listdir(prof) == ['trace.json']
  for name in names:
    assert _spans(os.path.join(prof, 'trace.json'), name), name
