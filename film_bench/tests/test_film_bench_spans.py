"""The readers of the program's own spans (`fi.<what>`, marked by
frame_interpolation_tpu_torch/utils/profiling.span) on small synthetic
traces: each reads what the trace holds, the chunks' share of the idle
device follows the launch and not the device's clock, and a program that
marks nothing (one older than its spans) gives None from every one."""
import types

import pytest

from film_bench import bench
from film_bench import trace as trace_lib

PAIR = ('upload_ms.pair', 'replay_host_ms.pair', 'download_ms.pair',
        'graph_hits.pair')
VIDEO = ('chunk_host_ms.video', 'fetch_wait_ms.video', 'chunk_idle_ms.video',
         'graph_hits.video')


def _annotation(name, start, dur):
  return {'ph': 'X', 'cat': 'user_annotation', 'name': name, 'ts': start,
          'dur': dur}


def _launched(name, launch, start, dur, k):
  """A device operation from its launching host call (correlation k)."""
  return [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaGraphLaunch',
           'ts': launch, 'dur': 50, 'args': {'correlation': k}},
          {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': start, 'dur': dur,
           'args': {'correlation': k}}]


def pair_events(marked=True):
  """A 100 ms window with two requests of 40 ms: 0.8 ms of uploads, 0.4 of
  replay and 2.5 of download each, an upload outside both, and a capture
  in the window besides the two replays."""
  events = [_annotation('film_bench.window', 0, 100_000)]
  for k, start in enumerate((0, 50_000)):
    events += [_annotation('film_bench.request', start, 40_000)]
    events += _launched('sm90_xmma_fprop_implicit_gemm_bf16', start + 1_700,
                        start + 2_000, 30_000, k)
    if marked:
      events += [_annotation('fi.upload', start + 100, 300),
                 _annotation('fi.upload', start + 500, 300),
                 _annotation('fi.upload', start + 900, 200),
                 _annotation('fi.replay.pair', start + 1_200, 400),
                 _annotation('fi.download', start + 33_000, 2_500)]
  if marked:
    events += [_annotation('fi.upload', 45_000, 1_000),
               _annotation('fi.capture.pair', 92_000, 5_000)]
  return events


def video_events(marked=True, device_ahead_us=0):
  """A 100 ms window, two chunks ([10, 20) and [60, 75) ms) and two fetch
  waits (5 and 2 ms). Four operations: the second launched at 19 ms,
  inside the first chunk, starts at 21 ms (a 6 ms gap after the first);
  the third launched outside any chunk (a 5 ms gap); the fourth launched
  inside the second chunk (a 3 ms gap). The device's clock runs
  `device_ahead_us` ahead of the host's."""
  events = [_annotation('film_bench.window', 0, 100_000)]
  for k, (launch, start, dur) in enumerate(((4_000, 5_000, 10_000),
                                            (19_000, 21_000, 19_000),
                                            (36_000, 45_000, 25_000),
                                            (61_000, 73_000, 17_000))):
    events += _launched('elementwise_kernel', launch,
                        start + device_ahead_us, dur, k)
  if marked:
    events += [_annotation('fi.chunk', 10_000, 10_000),
               _annotation('fi.chunk', 60_000, 15_000),
               _annotation('fi.fetch_wait', 30_000, 5_000),
               _annotation('fi.fetch_wait', 80_000, 2_000)]
    events += [_annotation(name, start, 500) for name, start in (
        ('fi.replay.features', 11_000), ('fi.replay.tree_pair', 12_000),
        ('fi.replay.tree_pair', 62_000), ('fi.replay.tree_pair', 63_000))]
  return events


def _ctx(cell, **extra):
  workload = bench.load_json('workloads', cell)
  ctx = types.SimpleNamespace(
      workload=workload, config=bench.load_json('configs',
                                                workload['config']),
      traced_units=0, untraced_units=0, untraced_s=0.0)
  ctx.__dict__.update(extra)
  return ctx


def _read(name, events, ctx):
  return bench.load_reader(name).read(trace_lib.Trace(events), {}, ctx)


def test_the_span_readers_are_in_the_benchmark():
  listed = {m['name']: m for m in bench.benchmark()['per_layer']}
  for name in PAIR + VIDEO:
    cell = 'pair-1080p' if name.endswith('.pair') else 'video-1080p-t3'
    assert cell in listed[name]['workloads']
    assert callable(bench.load_reader(name).read)


@pytest.mark.parametrize('name, want', [
    ('upload_ms.pair', 0.8), ('replay_host_ms.pair', 0.4),
    ('download_ms.pair', 2.5), ('graph_hits.pair', 100 * 2 / 3)])
def test_pair_span_readers(name, want):
  assert _read(name, pair_events(), _ctx('pair-1080p')) == pytest.approx(
      want)


@pytest.mark.parametrize('name, want', [
    ('chunk_host_ms.video', 25 / 4), ('fetch_wait_ms.video', 7 / 4),
    ('chunk_idle_ms.video', (6 + 3) / 4), ('graph_hits.video', 100.0)])
def test_video_span_readers(name, want):
  ctx = _ctx('video-1080p-t3', traced_units=4)
  assert _read(name, video_events(), ctx) == pytest.approx(want)


def test_chunk_idle_follows_the_launch_not_the_device_clock():
  """The device's clock 3 ms ahead of the host's moves every gap by as
  much, and no gap into or out of a chunk: each is the chunk's by the
  host call that launched the operation ending it."""
  ctx = _ctx('video-1080p-t3', traced_units=4)
  level = _read('chunk_idle_ms.video', video_events(), ctx)
  ahead = _read('chunk_idle_ms.video', video_events(device_ahead_us=3_000),
                ctx)
  assert level == ahead == pytest.approx(9 / 4)


def test_chunk_idle_leaves_out_the_stretch_before_its_first_operation():
  """A trace that begins while the device still runs work launched before
  it: the stretch's first 5 ms show nothing on the device, and the first
  operation was launched inside a chunk. The device was not idle there
  as far as the trace can tell, so that gap is nobody's."""
  events = video_events() + [_annotation('fi.chunk', 1_000, 4_000)]
  ctx = _ctx('video-1080p-t3', traced_units=4)
  assert _read('chunk_idle_ms.video', events, ctx) == pytest.approx(9 / 4)


def test_the_breakdown_names_the_chunk_that_starved_the_device():
  gaps = dict(trace_lib.Trace(video_events()).breakdown()['idle_gaps'])
  # The gaps from 15 and 70 ms (6 and 3 ms) begin inside the chunks.
  assert gaps['fi.chunk'] == pytest.approx(0.009)


@pytest.mark.parametrize('name', PAIR + VIDEO)
def test_a_program_without_spans_gives_nothing(name):
  if name in PAIR:
    events, ctx = pair_events(marked=False), _ctx('pair-1080p')
  else:
    events, ctx = (video_events(marked=False),
                   _ctx('video-1080p-t3', traced_units=4))
  assert _read(name, events, ctx) is None
