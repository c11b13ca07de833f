"""The port's benchmark-eval slice against the JAX package's, on the CPU.

metrics_lib, eval_loop and run_evaluation of the port against JAX's on the
same batches and the same tiny-config weights (numpy seed, zero biases),
each mean within 1e-4 relative: the forwards agree to about 1e-6 in f32,
and SSIM's and PSNR's reductions add a few ulps more. Then the train
loop's eval hook and the train CLI's eval flags.
"""
import os

import numpy as np
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.cli import eval_benchmark as jax_eval_benchmark
from frame_interpolation_tpu.data import records as jax_records
from frame_interpolation_tpu.data import tfrecord as jax_tfrecord
from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.training import eval_lib as jax_eval_lib
from frame_interpolation_tpu.training import metrics_lib as jax_metrics_lib
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.cli import eval_benchmark
from frame_interpolation_tpu_torch.cli import train as train_cli
from frame_interpolation_tpu_torch.inference import load_interpolator
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import (eval_lib, metrics_lib,
                                                    train_lib)

torch.set_num_threads(2)

REL_BOUND = 1e-4
METRICS = ['l1', 'l2', 'ssim', 'psnr']
H, W = 32, 48


@pytest.fixture(scope='module')
def tiny_state():
  """Lecun-normal kernels from a numpy seed and zero biases."""
  rng = np.random.RandomState(3)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    if value.dim() == 4:
      array = rng.randn(*value.shape) * np.prod(value.shape[1:])**-0.5
    else:
      array = np.zeros(value.shape)
    state[name] = torch.from_numpy(array.astype(np.float32))
  return state


def _batch(seed, n=2, h=H, w=W):
  rng = np.random.RandomState(seed)
  frames = rng.rand(3, n, h, w, 3).astype(np.float32)
  return {'x0': frames[0], 'y': frames[1], 'x1': frames[2],
          'time': np.full((n, 1), 0.5, np.float32)}


def _metric_fns():
  test = ['l1', 'l2', 'ssim', 'psnr']
  weights = [1.0, 2.0, 1.0, 0.5]
  return (metrics_lib.create_metrics_fns(
              losses.test_losses(test, loss_weights=weights),
              losses.training_losses(['l1', 'l2'], loss_weights=[1.0, 0.25])),
          jax_metrics_lib.create_metrics_fns(
              jax_losses.test_losses(test, loss_weights=weights),
              jax_losses.training_losses(['l1', 'l2'],
                                         loss_weights=[1.0, 0.25])))


def _assert_close(got, want):
  assert got.keys() == want.keys()
  for name in want:
    assert abs(got[name] - want[name]) <= REL_BOUND * abs(want[name]), name


def test_metrics_match_jax():
  batch = _batch(0)
  rng = np.random.RandomState(1)
  image = (batch['y'] + 0.1 * rng.randn(*batch['y'].shape)).astype(
      np.float32)
  ours, theirs = _metric_fns()
  example_t = {k: torch.from_numpy(v) for k, v in batch.items()}
  got = {k: float(fn(example_t, {'image': torch.from_numpy(image)}, 5))
         for k, fn in ours.items()}
  want = {k: float(fn(batch, {'image': image}, 5))
          for k, fn in theirs.items()}
  # The test loss 'l1' (weight 1) takes the plain L1 metric's name.
  assert set(got) == {'l1', 'training_loss', 'k*l2', 'ssim', 'k*psnr'}
  _assert_close(got, want)


class _Recorder:
  """A summary writer that keeps what it is given."""

  def __init__(self):
    self.images, self.scalars = {}, {}

  def image(self, tag, image, step):
    self.images[tag] = (np.asarray(image), step)

  def scalar(self, tag, value, step):
    self.scalars[tag] = (float(value), step)


def test_eval_loop_matches_jax(tiny_state):
  datasets = {'a': [_batch(2), _batch(3)], 'b': [_batch(4, n=1)]}
  ours, theirs = _metric_fns()
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(tiny_state)
  model.train()
  writer = _Recorder()
  got = eval_lib.eval_loop(model, datasets, ours, 7, writer=writer,
                           max_summary_batches=1, log_fn=lambda _: None)
  want = jax_eval_lib.eval_loop(
      jax_film_net.FilmNet(JaxOptions.tiny()),
      params_io.to_flax_params(tiny_state), datasets, theirs, 7,
      log_fn=lambda _: None)
  assert got.keys() == want.keys() == {'a', 'b'}
  for name in want:
    _assert_close(got[name], want[name])
  assert model.training  # restored after the loop
  # One grid per dataset (max_summary_batches=1): x0 | clip(pred) | y | x1.
  assert sorted(writer.images) == ['eval/a/x0_pred_y_x1_0',
                                   'eval/b/x0_pred_y_x1_0']
  grid, step = writer.images['eval/a/x0_pred_y_x1_0']
  assert grid.shape == (H, 4 * W, 3) and step == 7
  assert grid.min() >= 0.0 and grid.max() <= 1.0
  np.testing.assert_array_equal(grid[:, 2 * W:3 * W], datasets['a'][0]['y'][0])
  assert writer.scalars['eval/b/ssim'] == (got['b']['ssim'], 7)
  assert len(writer.scalars) == 2 * len(ours)


@pytest.fixture(scope='module')
def eval_tfrecord(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('rec') / 'eval.tfrecord')
  rng = np.random.RandomState(0)
  with jax_tfrecord.TFRecordWriter(
      jax_tfrecord.shard_filename(path, 0, 1)) as writer:
    for i in range(4):
      frames = [rng.randint(0, 256, (H, W, 3), np.uint8) for _ in range(3)]
      writer.write(jax_records.make_triplet_example(
          frames, path=f'clips/example_{i:02d}.png'))
  return f'{path}@1'


def _rows(out_dir):
  lines = open(os.path.join(out_dir, 'results.csv')).read().splitlines()
  rows = [line.split(', ') for line in lines]
  return rows[0], [(r[0], [float(v) for v in r[1:]]) for r in rows[1:]]


def test_run_evaluation_matches_jax(tiny_state, eval_tfrecord, tmp_path):
  bundle = str(tmp_path / 'bundle')
  params_io.save_state_bundle(bundle, tiny_state, Options.tiny())
  interp = load_interpolator(bundle, align=16, device='cpu')
  got = eval_benchmark.run_evaluation(
      interp, eval_tfrecord, str(tmp_path / 'port'), -1, METRICS,
      output_frames=True, model_description='tiny')
  want = jax_eval_benchmark.run_evaluation(
      jax_interp.Interpolator(params_io.to_flax_params(tiny_state),
                              JaxOptions.tiny(), align=16),
      eval_tfrecord, str(tmp_path / 'jax'), -1, METRICS)
  _assert_close(got, want)
  header, rows = _rows(str(tmp_path / 'port'))
  want_header, want_rows = _rows(str(tmp_path / 'jax'))
  assert header == want_header == ['key'] + METRICS
  assert [k for k, _ in rows] == [k for k, _ in want_rows] == [
      f'example_{i:02d}' for i in range(4)] + ['mean']
  for (_, values), (_, want_values) in zip(rows, want_rows):
    np.testing.assert_allclose(values, want_values, rtol=REL_BOUND)
  readme = open(str(tmp_path / 'port' / 'readme.txt')).read()
  assert 'tiny' in readme and eval_tfrecord in readme
  for name in ('image', 'x0', 'x1', 'y', 'x0_warped', 'x1_warped'):
    assert os.path.isfile(str(tmp_path / 'port' / f'example_03_{name}.png'))
  # Batches of 2 + 1 write the same rows, one per example.
  eval_benchmark.run_evaluation(interp, eval_tfrecord, str(tmp_path / 'b3'),
                                3, METRICS, batch_size=2)
  _, rows3 = _rows(str(tmp_path / 'b3'))
  assert [k for k, _ in rows3] == ['example_00', 'example_01', 'example_02',
                                   'mean']
  for (_, values), (_, want_values) in zip(rows3[:3], rows[:3]):
    np.testing.assert_allclose(values, want_values, rtol=REL_BOUND)


def test_eval_cli_on_cpu(tiny_state, eval_tfrecord, tmp_path, capsys):
  bundle = str(tmp_path / 'bundle')
  params_io.save_state_bundle(bundle, tiny_state, Options.tiny())
  eval_benchmark.main(['--params', bundle, '--tfrecord', eval_tfrecord,
                       '--output_dir', str(tmp_path / 'out'),
                       '--metrics', 'l1,psnr', '--max_examples', '2',
                       '--device', 'cpu'])
  header, rows = _rows(str(tmp_path / 'out'))
  assert header == ['key', 'l1', 'psnr'] and len(rows) == 3
  assert 'mean: l1=' in capsys.readouterr().out


def test_train_loop_calls_eval_at_each_save_interval(tmp_path):
  options = Options.tiny()
  calls = []

  def batches():
    seed = 10
    while True:
      seed += 1
      yield _batch(seed, n=1, h=16, w=16)

  def eval_fn(state, step):
    calls.append((step, state.step))

  train_lib.train(film_net.create_model(options), options,
                  losses.training_losses(['l1']), batches(),
                  train_lib.TrainingOptions(num_steps=5, save_interval=2),
                  str(tmp_path), device='cpu', eval_fn=eval_fn,
                  log_fn=lambda _: None)
  # Saves at 2, 4 and at the last step, 5; each is followed by the eval.
  assert calls == [(2, 2), (4, 4), (5, 5)]


def test_train_cli_eval_flags_need_one_name_per_file():
  with pytest.raises(SystemExit):
    train_cli.main(['--base_folder', 'runs', '--eval_files=a,b',
                    '--eval_names=a'])
  args = train_cli._parser().parse_args(
      ['--base_folder', 'runs', '--eval_files=a.tfrecord@2,b',
       '--eval_names=mid,ucf', '--eval_max_examples', '3'])
  assert (args.eval_files, args.eval_names, args.eval_max_examples) == (
      ['a.tfrecord@2', 'b'], ['mid', 'ucf'], 3)
