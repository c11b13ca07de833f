"""The harness's data: every file loads by the name BENCHMARK.json gives
it, a new file is picked up with no edit, and each reader reads a small
synthetic trace right."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from film_bench import bench
from film_bench import trace as trace_lib


def test_every_name_in_the_benchmark_has_its_file():
  spec = bench.benchmark()
  for config in spec['configs']:
    assert bench.load_json('configs', config['name'])['name'] == config['name']
    assert config['file'] == f'film_bench/configs/{config["name"]}.json'
  for cell in spec['workloads']:
    workload = bench.load_json('workloads', cell['name'])
    assert workload['config'] == cell['config']
    assert bench.load_driver(workload['entry']).Driver
    assert set(workload['limits'])
  for metric in spec['per_layer']:
    assert callable(bench.load_reader(metric['name']).read)


def test_a_configuration_states_every_option():
  from frame_interpolation_tpu_torch.options import Options
  for name in ('film_net-released-bf16', 'film_net-Style-f32'):
    model = bench.load_json('configs', name)['model']
    fields = set(Options.__dataclass_fields__)
    assert set(model) == fields
    released = Options.film_net_released()
    assert all(getattr(released, k) == (tuple(v) if isinstance(v, list)
                                        else v)
               for k, v in model.items() if k != 'dtype_policy')


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
  copy = tmp_path / 'film_bench'
  shutil.copytree(bench.BENCH_DIR, copy,
                  ignore=shutil.ignore_patterns('__pycache__'))
  workload = json.loads((copy / 'workloads' / 'pair-1080p.json').read_text())
  workload['name'] = 'pair-720p'
  workload['traffic'].update(height=720, width=1280)
  (copy / 'workloads' / 'pair-720p.json').write_text(json.dumps(workload))
  (copy / 'metrics' / 'requests.pair.py').write_text(
      'def read(trace, outcome, ctx):\n'
      '  return float(len(trace.named("request")))\n')
  monkeypatch.setattr(bench, 'BENCH_DIR', copy)
  assert bench.load_json('workloads', 'pair-720p')['traffic']['height'] == 720
  reader = bench.load_reader('requests.pair')
  assert reader.read(trace_lib.Trace([_span('request', 0, 5)]), {}, None) == 1.0


def _span(unit, start, dur):
  return {'ph': 'X', 'cat': 'user_annotation', 'name': 'film_bench.' + unit,
          'ts': start, 'dur': dur}


def _kernel(name, start, dur, cat='kernel'):
  return {'ph': 'X', 'cat': cat, 'name': name, 'ts': start, 'dur': dur}


def _host(name, start, dur):
  return {'ph': 'X', 'cat': 'cuda_runtime', 'name': name, 'ts': start,
          'dur': dur}


CONV = 'void (anonymous namespace)::conv3x3_wgmma_kernel<__nv_bfloat16, 128>(x)'
SPLAT_SCAN = 'void (anonymous namespace)::splat_scan_kernel(int*)'
SPLAT_SUM = 'void (anonymous namespace)::splat_tile_sum_kernel<float>(x)'


@pytest.fixture
def pair_trace():
  """A 100 ms window with two requests of 40 ms: each runs 10 ms of the
  port's conv and 20 ms of a library kernel, with a 2 ms copy."""
  events = [_span('window', 0, 100_000)]
  for start in (0, 50_000):
    events += [_span('request', start, 40_000),
               _kernel(CONV, start + 1_000, 10_000),
               _kernel('sm90_xmma_fprop_implicit_gemm_bf16', start + 12_000,
                       20_000),
               _kernel('Memcpy DtoH (Device -> Pageable)', start + 33_000,
                       2_000, cat='gpu_memcpy'),
               _host('cudaMemcpyAsync', start + 32_500, 7_000)]
  return trace_lib.Trace(events)


def _ctx(cell, **extra):
  workload = bench.load_json('workloads', cell)
  config = bench.load_json('configs', workload['config'])
  ctx = types.SimpleNamespace(workload=workload, config=config,
                              traced_units=0, untraced_units=0,
                              untraced_s=0.0)
  ctx.__dict__.update(extra)
  return ctx


def test_pair_readers(pair_trace):
  ctx = _ctx('pair-1080p')
  outcome = {'untraced_ms': [50.0, 60.0, 70.0], 'flops_per_unit': 8.87e12}

  def read(name):
    return bench.load_reader(name).read(pair_trace, outcome, ctx)

  assert read('pair_ms_p50') == 60.0
  assert read('request_host_ms.pair') == pytest.approx(10.0)  # 40 - 30
  assert read('library_ms.pair') == pytest.approx(20.0)
  # 2.137 ms of bound over 10 ms of conv a request.
  assert read('conv3x3_roofline.pair') == pytest.approx(21.37, abs=0.01)
  assert read('idle_share.pair') == pytest.approx(100 * (1 - 64 / 100))
  assert read('mfu.pair') == pytest.approx(100 * 8.87e12 / 0.060 / 989e12)
  breakdown = pair_trace.breakdown()
  assert breakdown['device_ops'][0] == ['sm90_xmma_fprop_implicit_gemm_bf16',
                                        0.04]
  names = dict(breakdown['idle_gaps'])
  # A gap goes to the host operation running when it began: the copy's
  # call from 35 to 51 ms and from 85 to 100.
  assert names['cudaMemcpyAsync'] == pytest.approx(0.031)
  assert sum(names.values()) == pytest.approx(0.036)


def test_pair_readers_follow_the_launch_not_the_device_clock():
  """The device's clock 3 ms ahead of the host's: each request's kernels
  seem to start before its span, and still count as its own by the
  graph launch that the trace links them to."""
  events = [_span('window', 0, 100_000)]
  for k, start in enumerate((10_000, 60_000)):
    launch = dict(_host('cudaGraphLaunch', start + 500, 100),
                  args={'correlation': k})
    events += [_span('request', start, 40_000), launch]
    for name, offset, dur in ((CONV, 1_000, 10_000),
                              ('sm90_xmma_fprop_implicit_gemm_bf16', 12_000,
                               20_000)):
      events.append(dict(_kernel(name, start + offset - 3_000, dur),
                         args={'correlation': k}))
  trace = trace_lib.Trace(events)
  ctx = _ctx('pair-1080p')

  def read(name):
    return bench.load_reader(name).read(trace, {}, ctx)

  assert read('request_host_ms.pair') == pytest.approx(10.0)  # 40 - 30
  assert read('library_ms.pair') == pytest.approx(20.0)
  assert read('conv3x3_roofline.pair') == pytest.approx(21.37, abs=0.01)


def test_readers_read_nothing_where_nothing_ran():
  empty = trace_lib.Trace([_span('window', 0, 1000)])
  ctx = _ctx('pair-1080p')
  for name in ('request_host_ms.pair', 'library_ms.pair',
               'conv3x3_roofline.pair'):
    assert bench.load_reader(name).read(empty, {}, ctx) is None
  assert bench.load_reader('splat_roofline.train').read(
      empty, {}, _ctx('train-style-256')) is None


def test_train_and_video_readers():
  from film_bench.costs import film_net as costs
  from film_bench.drivers import common
  ctx = _ctx('train-style-256', untraced_units=20, untraced_s=2.5)
  options = common.options_dict(ctx.config)
  # Two steps' splats: 44 scans and 44 sums of 20 us each, in 10 ms.
  events = [_span('window', 0, 10_000)]
  for i in range(44):
    events += [_kernel(SPLAT_SCAN, i * 200, 10), _kernel(SPLAT_SUM,
                                                         i * 200 + 50, 20)]
  trace = trace_lib.Trace(events)
  bound = costs.splat_bound_ms(options, 8, 256, 256)
  assert bench.load_reader('splat_roofline.train').read(
      trace, {}, ctx) == pytest.approx(100 * 2 * bound / (44 * 30 / 1e3))
  flops = sum(costs.train_step_flops(options, 8, 256, 256,
                                     (64, 64, 128, 128, 256, 256, 256, 256,
                                      512, 512, 512, 512, 512,
                                      512)).values())
  from film_bench.costs import peaks
  assert bench.load_reader('mfu.train').read(trace, {}, ctx) == pytest.approx(
      100 * flops * 8 / peaks.PEAK_FLOPS[ctx.config['mfu_peak']])
  video = _ctx('video-1080p-t3', traced_units=4, untraced_units=10,
               untraced_s=0.5)
  assert bench.load_reader('device_ms_per_frame.video').read(
      trace, {}, video) == pytest.approx(44 * 30 / 1e3 / 4)
  assert bench.load_reader('mfu.video').read(
      trace, {'flops_per_unit': 7e12}, video) == pytest.approx(
          100 * 7e12 * 20 / 989e12)


def test_a_run_without_a_card_prints_no_result():
  env = dict(os.environ, CUDA_VISIBLE_DEVICES='-1')
  run = subprocess.run(
      [sys.executable, str(bench.BENCH_DIR / 'run.py'), '--workload',
       'pair-1080p', '--seed', str(2**31 + 5), '--seconds', '1', '--trace',
       '0'], capture_output=True, text=True, env=env, timeout=300)
  assert run.returncode != 0
  assert run.stdout.strip() == ''
  assert 'no CUDA device' in run.stderr


def test_a_run_with_only_the_benchmark_files_fails(tmp_path):
  shutil.copytree(bench.BENCH_DIR, tmp_path / 'film_bench',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(bench.ROOT / 'BENCHMARK.json', tmp_path)
  run = subprocess.run(
      [sys.executable, 'film_bench/run.py', '--workload', 'pair-1080p',
       '--seed', '3', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
      capture_output=True, text=True, timeout=300)
  assert run.returncode != 0
  assert run.stdout.strip() == ''


def test_the_forbidden_modules_are_matched_whole(monkeypatch):
  monkeypatch.setitem(sys.modules, 'jaxtyping_like', types.ModuleType('x'))
  assert bench.forbidden_loaded() == []
  monkeypatch.setitem(sys.modules, 'flax.core', types.ModuleType('flax.core'))
  assert bench.forbidden_loaded() == ['flax']


def test_the_card_runs_a_cell(card, tmp_path):
  """On the card: a short run of the pair cell prints a correct result."""
  run = subprocess.run(
      [sys.executable, str(bench.BENCH_DIR / 'run.py'), '--workload',
       'pair-1080p', '--seed', str(2**31 + 17), '--seconds', '3', '--trace',
       '0'], capture_output=True, text=True, timeout=900)
  assert run.returncode == 0, run.stderr[-2000:]
  assert json.loads(run.stdout.strip().splitlines()[-1])['correct']


test_the_card_runs_a_cell = pytest.mark.card(test_the_card_runs_a_cell)
