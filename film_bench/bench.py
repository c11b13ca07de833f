"""The harness: one run of one cell, driven by the files it names.

  python3 film_bench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

finds `film_bench/workloads/<cell>.json`, its configuration
`film_bench/configs/<config>.json` and its driver
`film_bench/drivers/<entry>.py`, and reads from `BENCHMARK.json` which
metrics the cell reports. A driver sets the program up (weights and
inputs from the seed, every shape the traffic uses warmed), runs the
measured window, hands over what it kept, frees the program and checks
what the program produced against the plain reference. With `--trace 1`
a stretch of the window is traced and each per-layer metric is read by
its own reader, `film_bench/metrics/<metric>.py`, which returns a number
or None (nothing to read there).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with a trace
`breakdown`), and last `checks`, each number compared with its limit;
the checks are also the last lines on standard error. A run with no card,
too few cards, or JAX loaded once the window has closed exits with an
error and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Compared whole with each loaded module's top-level name.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'frame_interpolation_tpu')
CACHE_DIR = ROOT / '.film_bench_cache'
# The host's threads for the port's CPU work (uploads, downloads, numpy).
HOST_THREADS = 4


class RunError(RuntimeError):
  """A run that cannot give a result (no card, a forbidden import)."""


def load_json(kind: str, name: str) -> dict:
  path = BENCH_DIR / kind / f'{name}.json'
  if not path.is_file():
    raise RunError(f'no {kind[:-1]} named {name!r} ({path} is missing)')
  with open(path) as f:
    return json.load(f)


def benchmark() -> dict:
  with open(ROOT / 'BENCHMARK.json') as f:
    return json.load(f)


def applies(metric: dict, cell: str) -> bool:
  return 'workloads' not in metric or cell in metric['workloads']


def load_reader(metric: str):
  """The per-layer metric's reader module, by its file name."""
  path = BENCH_DIR / 'metrics' / f'{metric}.py'
  if not path.is_file():
    raise RunError(f'no reader for metric {metric!r} ({path} is missing)')
  spec = importlib.util.spec_from_file_location(
      'film_bench_metric_' + metric.replace('.', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def load_driver(entry: str):
  return importlib.import_module(f'film_bench.drivers.{entry}')


def forbidden_loaded() -> List[str]:
  return sorted({name.split('.')[0] for name in list(sys.modules)} &
                set(FORBIDDEN_MODULES))


def process_age_s() -> Optional[float]:
  """Seconds since this process started, from /proc (None elsewhere)."""
  try:
    with open('/proc/self/stat') as f:
      fields = f.read().rsplit(')', 1)[1].split()
    with open('/proc/uptime') as f:
      uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK')
  except (OSError, ValueError, IndexError):
    return None


def use_checkout_caches() -> None:
  """Kernel caches at fixed paths inside the checkout."""
  os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE_DIR / 'torch_extensions')
  os.environ['TRITON_CACHE_DIR'] = str(CACHE_DIR / 'triton')


def power_limit() -> Optional[str]:
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError):
    return None


class Context:
  """What a driver gets: the run's arguments and files, the clock that
  marks the end of set-up, and the tracer of the window."""

  def __init__(self, workload_name: str, workload: dict, config: dict,
               seed: int, seconds: float, trace: bool, device,
               started: float):
    self.name = workload_name
    self.workload = workload
    self.config = config
    self.seed = seed
    self.seconds = seconds
    self.trace = trace
    self.device = device
    self._started = started  # perf_counter at process start
    self.setup_s: Optional[float] = None
    self._profiler = None
    self._window_span = None
    self._window_start = None
    self._stopped = None
    self.trace_data = None
    self.traced_units = 0
    self.untraced_units = 0
    self.untraced_s = 0.0

  # -- set-up and window ------------------------------------------------------

  def open_window(self) -> float:
    """Marks the end of set-up; returns the window's start (perf_counter)."""
    now = time.perf_counter()
    self.setup_s = now - self._started
    self._window_start = now
    return now

  @property
  def tracing(self) -> bool:
    """Whether the traced stretch is running."""
    return self._profiler is not None

  def span(self, unit: str):
    """A `film_bench.<unit>` span in the trace while it is traced."""
    if self._profiler is None:
      return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function('film_bench.' + unit)

  def tick(self, units_done: int = 0) -> None:
    """Called between units of work: counts them, and starts the traced
    stretch, the window's last `trace_seconds` (the window's end stops
    it, so that no later unit waits for the tracer to stop)."""
    if self._window_start is None:
      return
    if self._profiler is not None:
      self.traced_units += units_done
      return
    self.untraced_units += units_done
    elapsed = time.perf_counter() - self._window_start
    self.untraced_s = elapsed
    length = float(self.workload.get('trace_seconds', 3.0))
    if self.trace and self._stopped is None and (
        elapsed >= self.seconds - length):
      self._start_trace()

  def prepare_trace(self) -> None:
    """Starts and stops a profiler once in set-up, so that the window's
    trace does not pay the tracer's first start (seconds)."""
    if not self.trace:
      return
    import torch
    self._start_trace()
    torch.ones(1, device=self.device).add_(1)
    self.stop_trace()
    self._stopped = None

  def _start_trace(self) -> None:
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    self._profiler = torch.profiler.profile(activities=activities)
    self._profiler.start()
    self._window_span = torch.profiler.record_function('film_bench.window')
    self._window_span.__enter__()

  def stop_trace(self) -> None:
    """Ends the traced stretch once the device is done (the window's end
    stops it too)."""
    if self._profiler is None:
      return
    import torch
    torch.cuda.synchronize()
    self._window_span.__exit__(None, None, None)
    self._profiler.stop()
    self._stopped, self._profiler = self._profiler, None

  def read_trace(self) -> None:
    """Reads the stopped trace (after the window: it takes seconds)."""
    if self._stopped is not None:
      from . import trace as trace_lib
      self.trace_data = trace_lib.Trace.from_profiler(self._stopped)
      self._stopped = None


def _metric_entries(spec: dict, cell: str, trace: bool) -> List[dict]:
  group = spec['per_layer'] if trace else spec['end_to_end']
  return [m for m in group if applies(m, cell)]


def _checks_text(checks: List[Tuple[str, float, float]]) -> List[str]:
  return [f'check {name}: {value!r} limit {limit!r} '
          f'{"ok" if value <= limit else "FAILED"}'
          for name, value, limit in checks]


def run(args: argparse.Namespace, started: float) -> dict:
  """One run; returns the result object (raises RunError where there is
  none to give)."""
  use_checkout_caches()
  spec = benchmark()
  cells = {w['name']: w for w in spec['workloads']}
  if args.workload not in cells:
    raise RunError(f'BENCHMARK.json has no cell {args.workload!r}')
  cell = cells[args.workload]
  workload = load_json('workloads', args.workload)
  config = load_json('configs', workload['config'])
  import torch
  if not torch.cuda.is_available():
    raise RunError('no CUDA device: this benchmark measures the card only')
  if torch.cuda.device_count() < int(cell['chips']):
    raise RunError(f'the cell needs {cell["chips"]} cards; '
                   f'{torch.cuda.device_count()} visible')
  torch.set_num_threads(HOST_THREADS)
  device = torch.device('cuda', 0)
  ctx = Context(args.workload, workload, config, args.seed, args.seconds,
                bool(args.trace), device, started)
  driver = load_driver(workload['entry']).Driver(ctx)
  driver.setup()
  ctx.prepare_trace()
  outcome = driver.window()
  ctx.stop_trace()
  torch.cuda.synchronize()
  ctx.read_trace()
  memory_peak = max(torch.cuda.max_memory_reserved(i)
                    for i in range(int(cell['chips'])))
  values = dict(outcome.get('metrics', {}))
  values['setup_s'] = ctx.setup_s
  values['peak_mem_gib'] = memory_peak / 2**30
  metrics: Dict[str, Dict[str, Any]] = {}
  breakdown = None
  if args.trace:
    if ctx.trace_data is None:
      raise RunError('the window ended before its traced stretch began')
    for entry in _metric_entries(spec, args.workload, True):
      value = load_reader(entry['name']).read(ctx.trace_data, outcome, ctx)
      if value is not None:
        metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    breakdown = ctx.trace_data.breakdown()
  else:
    for entry in _metric_entries(spec, args.workload, False):
      if entry['name'] not in values:
        raise RunError(f'the entry measured no {entry["name"]!r}')
      metrics[entry['name']] = {'value': values[entry['name']],
                                'unit': entry['unit']}
  device_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                 'count': int(cell['chips']),
                 'memory_peak_bytes': int(memory_peak),
                 'power_limit': power_limit()}
  if args.trace:
    device_info['busy_s'] = ctx.trace_data.busy_us() / 1e6
    device_info['window_s'] = ctx.trace_data.window_us / 1e6
  driver.release()
  gc.collect()
  torch.cuda.empty_cache()
  checks = driver.check()
  del driver
  loaded = forbidden_loaded()
  if loaded:
    raise RunError(f'loaded in this process once the window closed: '
                   f'{", ".join(loaded)}')
  failed = int(outcome.get('failed', 0))
  correct = failed == 0 and all(v <= limit for _, v, limit in checks)
  result = {'correct': correct, 'attempted': int(outcome['attempted']),
            'failed': failed, 'metrics': metrics, 'device': device_info}
  if breakdown is not None:
    result['breakdown'] = breakdown
  result['checks'] = {name: {'value': value, 'limit': limit}
                      for name, value, limit in checks}
  return result


def parse_args(argv) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return parser.parse_args(argv)


def main(argv, started: float) -> int:
  args = parse_args(argv)
  try:
    result = run(args, started)
  except RunError as e:
    print(f'film_bench: {e}', file=sys.stderr)
    return 2
  for line in _checks_text([(k, v['value'], v['limit'])
                            for k, v in result['checks'].items()]):
    print(line, file=sys.stderr)
  sys.stdout.flush()
  print(json.dumps(result))
  return 0
