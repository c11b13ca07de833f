"""The port's profiling helpers and the train loop's trace window, on the
CPU: `trace_if` writes a torch.profiler Chrome trace; `StepTimer` keeps the
JAX package's semantics; the window of `train_lib.train_loop` opens at
`profile_start_step`, closes after `profile_num_steps` steps (each an
`fi.train.step` span), and closes early when the run ends or fails inside
it. No JAX compile.
"""
import json
import os

import numpy as np
import pytest
import torch

from frame_interpolation_tpu.utils import profiling as jax_profiling
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import train_lib
from frame_interpolation_tpu_torch.utils import profiling

torch.set_num_threads(2)

_ADAM = 'Optimizer.step#Adam.step'


def _events(path):
  with open(path) as f:
    return json.load(f)['traceEvents']


def _steps_in(path, name=_ADAM):
  """Adam updates recorded in a trace (or the trainer's `fi.train.step`
  spans): one per train step."""
  return sum(1 for e in _events(path)
             if e.get('name') == name and e.get('cat') == 'user_annotation')


def test_trace_if_writes_a_trace(tmp_path):
  x = torch.ones(16, 16)
  with profiling.trace_if(str(tmp_path / 'prof')):
    torch.mm(x, x)
  names = {e.get('name') for e in _events(str(tmp_path / 'prof' /
                                                 'trace.json'))}
  assert 'aten::mm' in names
  with profiling.trace_if(None):
    torch.mm(x, x)
  with profiling.trace_if(''):
    torch.mm(x, x)
  assert os.listdir(str(tmp_path / 'prof')) == ['trace.json']


def test_step_timer_matches_jax(monkeypatch):
  clock = [100.0]
  monkeypatch.setattr(profiling.time, 'monotonic', lambda: clock[0])
  monkeypatch.setattr(jax_profiling.time, 'monotonic', lambda: clock[0])
  ours, theirs = profiling.StepTimer(3), jax_profiling.StepTimer(3)
  for step, now in ((1, 101.0), (2, 102.0), (3, 102.5), (5, 104.0),
                    (6, 104.5), (9, 106.0)):
    clock[0] = now
    assert ours.update(step) == theirs.update(step), step


def test_step_timer_counts_from_a_resumed_step(monkeypatch):
  clock = [10.0]
  monkeypatch.setattr(profiling.time, 'monotonic', lambda: clock[0])
  timer = profiling.StepTimer(4, start_step=20, device=torch.device('cpu'))
  clock[0] = 12.0
  assert timer.update(23) is None
  assert timer.update(24) == 4 / 2.0  # the 4 steps since 20, not 24


def _batches():
  rng = np.random.RandomState(0)
  batch = {k: rng.rand(1, 16, 16, 3).astype(np.float32)
           for k in ('x0', 'x1', 'y')}
  batch['time'] = np.full((1, 1), 0.5, np.float32)
  while True:
    yield batch


def _loop(run_dir, num_steps, profile_dir, batches=None, start=2, num=3):
  options = Options.tiny()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(0))
  state = train_lib.create_train_state(model, train_lib.TrainingOptions())
  log = []
  opts = train_lib.TrainingOptions(num_steps=num_steps, save_interval=4,
                                   timing_interval=4)
  train_lib.train_loop(state, losses.training_losses(['l1']),
                       batches or _batches(), opts, str(run_dir),
                       log_fn=log.append, profile_dir=str(profile_dir),
                       profile_start_step=start, profile_num_steps=num)
  return [line for line in log if 'profiler trace' in line]


@pytest.mark.parametrize('num_steps, window', [(7, (2, 5)), (4, (2, 4)),
                                               (2, None)],
                         ids=['full', 'ended_inside', 'before_window'])
def test_train_loop_trace_window(num_steps, window, tmp_path):
  prof = tmp_path / 'prof'
  lines = _loop(tmp_path / 'run', num_steps, prof)
  if window is None:
    assert lines == [] and not prof.exists()
    return
  first, end = window
  path = str(prof / f'steps_{first}_{end}.json')
  assert lines == [f'Wrote profiler trace for steps [{first}, {end}) to '
                   f'{path}']
  assert os.listdir(str(prof)) == [f'steps_{first}_{end}.json']
  assert _steps_in(path) == end - first
  assert _steps_in(path, 'fi.train.step') == end - first


def test_train_loop_trace_closes_on_failure(tmp_path):
  def failing():
    for i, batch in enumerate(_batches()):
      if i == 3:
        raise RuntimeError('input pipeline failed')
      yield batch

  with pytest.raises(RuntimeError, match='input pipeline failed'):
    _loop(tmp_path / 'run', 7, tmp_path / 'prof', batches=failing())
  path = str(tmp_path / 'prof' / 'steps_2_3.json')
  assert _steps_in(path) == 1


def test_resumed_run_past_the_window_traces_nothing(tmp_path):
  _loop(tmp_path / 'run', 4, tmp_path / 'first', start=5)
  lines = _loop(tmp_path / 'run', 7, tmp_path / 'second', start=2)
  assert lines == [] and not (tmp_path / 'second').exists()
