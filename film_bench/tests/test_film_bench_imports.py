"""Nothing the benchmark runs imports JAX, flax or the JAX package, and
its reference imports nothing of the port. Names are compared whole, by
their top-level part: `frame_interpolation_tpu_torch` is not
`frame_interpolation_tpu`."""
import ast
import subprocess
import sys

from film_bench import bench

GUARD = '''
import importlib, importlib.abc, sys
REFUSED = set(sys.argv[1].split(','))
class Refuse(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in REFUSED:
      raise ImportError('refused: ' + name)
    return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
from film_bench import bench
for module in sys.argv[3].split(','):
  importlib.import_module(module)
for metric in filter(None, sys.argv[4].split(',')):
  bench.load_reader(metric)
loaded = {m.split('.')[0] for m in sys.modules} & REFUSED
assert not loaded, loaded
print('ok')
'''


def _modules(folder: str):
  base = bench.BENCH_DIR / folder
  return [f'film_bench.{folder}.{p.stem}' for p in sorted(base.glob('*.py'))
          if p.stem != '__init__']


def _guarded(refused, modules, metrics=()):
  run = subprocess.run(
      [sys.executable, '-c', GUARD, ','.join(refused), str(bench.ROOT),
       ','.join(modules), ','.join(metrics)],
      capture_output=True, text=True, timeout=600)
  assert run.returncode == 0 and run.stdout.strip() == 'ok', run.stderr[-3000:]


def test_nothing_the_benchmark_runs_imports_jax():
  modules = (['film_bench.bench', 'film_bench.trace', 'film_bench.weights',
              'film_bench.controls', 'film_bench.sweep'] +
             _modules('drivers') + _modules('reference') + _modules('costs') +
             _modules('traffic') +
             # What the drivers import from the port when they run.
             ['frame_interpolation_tpu_torch.inference',
              'frame_interpolation_tpu_torch.inference.recursion',
              'frame_interpolation_tpu_torch.training.train_lib',
              'frame_interpolation_tpu_torch.losses',
              'frame_interpolation_tpu_torch.models.film_net'])
  metrics = [m['name'] for m in bench.benchmark()['per_layer']]
  _guarded(bench.FORBIDDEN_MODULES, modules, metrics)


def test_the_reference_imports_nothing_of_the_port():
  refused = bench.FORBIDDEN_MODULES + ('frame_interpolation_tpu_torch',)
  _guarded(refused, _modules('reference'))
  for path in (bench.BENCH_DIR / 'reference').glob('*.py'):
    for node in ast.walk(ast.parse(path.read_text())):
      names = ([a.name for a in node.names] if isinstance(node, ast.Import)
               else [node.module or ''] if isinstance(node, ast.ImportFrom)
               else [])
      for name in names:
        assert not name.startswith('frame_interpolation_tpu'), (path, name)


def test_the_guard_refuses_by_whole_name():
  # The port's name begins with the JAX package's: refusing the JAX
  # package must not refuse the port.
  _guarded(('frame_interpolation_tpu',),
           ['frame_interpolation_tpu_torch.options'])
  run = subprocess.run(
      [sys.executable, '-c', GUARD, 'frame_interpolation_tpu',
       str(bench.ROOT), 'frame_interpolation_tpu.options', ''],
      capture_output=True, text=True, timeout=600)
  assert run.returncode != 0
