"""The port's gin loader against the JAX package's, and the CLIs that read
gin files, on the CPU.

The reference's gin files are not in this tree, so the texts are written
inline, as the reference's film_net-{L1,VGG,Style}.gin and eval/config/
*.gin lay them out: `@...PiecewiseConstantDecay` references over several
lines, a quoted 'file@200' shard spec, the vgg/style weights bindings.
Every text loads into the same configuration, field for field, as through
the JAX package's gin_compat; both refuse an unknown binding. No JAX
compile.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from frame_interpolation_tpu.data import records as jax_records
from frame_interpolation_tpu.data import tfrecord as jax_tfrecord
from frame_interpolation_tpu.training.configs import gin_compat as jax_gin
from frame_interpolation_tpu_torch.cli import eval_benchmark, train
from frame_interpolation_tpu_torch.data import dataset
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.losses import vgg19
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import train_lib
from frame_interpolation_tpu_torch.training.configs import gin_compat

torch.set_num_threads(2)


def _write_vgg_mat(path):
  """A small-channel VGG-19 .mat of seeded weights, in MatConvNet's layout
  (vgg19.save_vgg_weights)."""
  pytest.importorskip('scipy.io')
  rng = np.random.RandomState(0)
  vgg19.save_vgg_weights(path, [
      ((rng.randn(3, 3, cin, 8) * (9 * cin)**-0.5).astype(np.float32),
       (rng.randn(8) * 0.1).astype(np.float32))
      for cin in (3,) + (8,) * 13])

_MODEL = """
model.name = 'film_net'
film_net.pyramid_levels = 7
film_net.fusion_pyramid_levels = 5
film_net.specialized_levels = 3
film_net.sub_levels = 4
film_net.flow_convs = [3, 3, 3, 3]
film_net.flow_filters = [32, 64, 128, 256]
film_net.filters = 64

training.learning_rate = 0.0001
training.learning_rate_decay_steps = 750000
training.learning_rate_decay_rate = 0.464158
training.learning_rate_staircase = True
training.num_steps = 3000000

# The shard spec is data: its '@' is not a gin reference.
training_dataset.file = 'vimeo_interp_train.tfrecord@200'
training_dataset.batch_size = 8
training_dataset.crop_size = 256

eval_datasets.batch_size = 1
eval_datasets.max_examples = -1
eval_datasets.files = []
eval_datasets.names = []

data_augmentation.names = ['random_image_rot90', 'random_flip',
                           'random_rotate', 'random_reverse']
test_losses.loss_names = ['l1', 'psnr', 'ssim']
test_losses.loss_weights = [1.0, 1.0, 1.0]
"""

_SCHEDULE = '@tf.keras.optimizers.schedules.PiecewiseConstantDecay'

GIN_TEXTS = {
    'L1': _MODEL + """
training_losses.loss_names = ['l1']
training_losses.loss_weights = [1.0]
""",
    'VGG': _MODEL + f"""
training_losses.loss_names = ['l1', 'vgg']
training_losses.loss_weight_schedules = [
    {_SCHEDULE},
    {_SCHEDULE}]
training_losses.loss_weight_parameters = [
    {{'boundaries': [0], 'values': [1.0, 1.0]}},
    {{'boundaries': [1500000], 'values': [1.0, 0.25]}}]
vgg.vgg_model_file = '{{mat}}'
""",
    'Style': _MODEL + f"""
training_losses.loss_names = ['l1', 'vgg', 'style']
training_losses.loss_weight_schedules = [
    {_SCHEDULE},
    {_SCHEDULE},
    {_SCHEDULE}]
training_losses.loss_weight_parameters = [
    {{'boundaries': [0], 'values': [1.0, 1.0]}},
    {{'boundaries': [1500000], 'values': [1.0, 0.25]}},
    {{'boundaries': [1500000], 'values': [0.0, 40.0]}}]
vgg.vgg_model_file = '{{mat}}'
style.vgg_model_file = '{{mat}}'
""",
}

EVAL_TEXT = """
experiment.name = 'middlebury'
evaluation.max_examples = {max_examples}
evaluation.metrics = ['l1', 'psnr']
evaluation.tfrecord = '{tfrecord}'
"""


@pytest.fixture(scope='module')
def vgg_mat(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('vgg') / 'imagenet-vgg-verydeep-19.mat')
  _write_vgg_mat(path)
  return path


def _write_gin(tmp_path, name, mat):
  path = str(tmp_path / f'film_net-{name}.gin')
  with open(path, 'w') as f:
    f.write(GIN_TEXTS[name].replace('{mat}', mat))
  return path


def _assert_same_config(ours, theirs):
  ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
  model, jax_model = ours.pop('model'), theirs.pop('model')
  assert ours == theirs
  assert all(jax_model[k] == v for k, v in model.items())


@pytest.mark.parametrize('name', ['L1', 'VGG', 'Style'])
def test_training_gin_matches_jax(name, tmp_path, vgg_mat):
  path = _write_gin(tmp_path, name, vgg_mat)
  ours = gin_compat.load_training_gin(path)
  _assert_same_config(ours, jax_gin.load_training_gin(path))
  assert ours.model == Options.film_net_released()
  assert ours.dataset.file == 'vimeo_interp_train.tfrecord@200'
  assert ours.vgg_model_file == (None if name == 'L1' else vgg_mat)
  # The flag overrides the gin's binding, in both.
  ours = gin_compat.load_training_gin(path, vgg_model_file='other.mat')
  _assert_same_config(ours, jax_gin.load_training_gin(
      path, vgg_model_file='other.mat'))
  assert ours.vgg_model_file == 'other.mat'
  if name == 'Style':
    vgg_w, style_w = ours.training_losses.weight_schedules[1:]
    assert (vgg_w(1500000), vgg_w(1500001)) == (1.0, 0.25)
    assert (style_w(1500000), style_w(1500001)) == (0.0, 40.0)


def test_eval_gin_matches_jax(tmp_path):
  path = str(tmp_path / 'middlebury.gin')
  with open(path, 'w') as f:
    f.write(EVAL_TEXT.format(max_examples=-1,
                             tfrecord='middlebury_other.tfrecord@3'))
  ours = gin_compat.load_eval_gin(path)
  assert dataclasses.asdict(ours) == dataclasses.asdict(
      jax_gin.load_eval_gin(path))
  assert ours.tfrecord == 'middlebury_other.tfrecord@3'


@pytest.mark.parametrize('loader', ['training', 'eval'])
def test_unknown_binding_raises_in_both(loader, tmp_path):
  path = str(tmp_path / 'bad.gin')
  with open(path, 'w') as f:
    f.write("training.learning_rate = 1e-4\nwho.knows = 3\n")
  fn = f'load_{loader}_gin'
  with pytest.raises(ValueError, match='who.knows'):
    getattr(gin_compat, fn)(path)
  with pytest.raises(ValueError, match='who.knows'):
    getattr(jax_gin, fn)(path)


def test_vgg_gin_without_weights_raises(tmp_path):
  path = str(tmp_path / 'vgg.gin')
  with open(path, 'w') as f:
    f.write(GIN_TEXTS['VGG'].replace("vgg.vgg_model_file = '{mat}'\n", ''))
  with pytest.raises(ValueError, match='vgg_model_file'):
    gin_compat.load_training_gin(path)


# ---- the CLIs -------------------------------------------------------------------


def test_train_cli_takes_the_gin_config(tmp_path, vgg_mat, monkeypatch):
  called = {}

  def fake_train(model, options, losses, iterator, opts, run_dir, **kwargs):
    called.update(options=options, losses=list(losses), opts=opts,
                  run_dir=run_dir, **kwargs)

  def fake_iterator(sources, batch_size, weights=None):
    called.update(sources=[(len(s.paths), s.crop_size) for s in sources],
                  batch_size=batch_size)
    return iter(())

  monkeypatch.setattr(train_lib, 'train', fake_train)
  monkeypatch.setattr(dataset, 'create_training_iterator', fake_iterator)
  gin = _write_gin(tmp_path, 'Style', vgg_mat)
  train.main(['--gin_config', gin, '--base_folder', str(tmp_path / 'runs'),
              '--num_steps', '4', '--profile_dir', str(tmp_path / 'prof'),
              '--device', 'cpu'])
  run = tmp_path / 'runs' / 'run0'
  config = json.loads((run / 'config.json').read_text())
  want = json.loads(json.dumps(dataclasses.asdict(
      gin_compat.load_training_gin(gin)), default=str))
  assert config == want
  assert config['training_losses']['names'] == ['l1', 'vgg', 'style']
  assert config['vgg_model_file'] == vgg_mat
  assert called['losses'] == ['l1', 'k*vgg', 'k*style']
  assert called['options'] == Options.film_net_released()
  assert called['opts'].num_steps == 4
  assert called['profile_dir'] == str(tmp_path / 'prof')
  assert called['run_dir'] == str(run)
  assert called['sources'] == [(200, 256)]  # the gin's file@200
  assert called['batch_size'] == 8


def _eval_tfrecord(tmp_path, h=24, w=32):
  path = str(tmp_path / 'eval.tfrecord')
  rng = np.random.RandomState(0)
  with jax_tfrecord.TFRecordWriter(
      jax_tfrecord.shard_filename(path, 0, 1)) as writer:
    for i in range(3):
      frames = [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(3)]
      writer.write(jax_records.make_triplet_example(
          frames, path=f'clips/example_{i:02d}.png'))
  return f'{path}@1'


def test_eval_cli_takes_the_gin_config(tmp_path):
  rng = np.random.RandomState(1)
  state = {name: torch.from_numpy(
      (rng.randn(*v.shape) * 0.1).astype(np.float32))
           for name, v in film_net.create_model(Options.tiny()).state_dict(
               ).items()}
  bundle = str(tmp_path / 'bundle')
  params_io.save_state_bundle(bundle, state, Options.tiny())
  tfrecord = _eval_tfrecord(tmp_path)
  gin = str(tmp_path / 'eval.gin')
  with open(gin, 'w') as f:
    f.write(EVAL_TEXT.format(max_examples=2, tfrecord=tfrecord))
  eval_benchmark.main(['--params', bundle, '--gin_config', gin,
                       '--output_dir', str(tmp_path / 'gin'),
                       '--device', 'cpu'])
  # The same as the flags that the gin file stands for.
  eval_benchmark.main(['--params', bundle, '--tfrecord', tfrecord,
                       '--metrics', 'l1,psnr', '--max_examples', '2',
                       '--output_dir', str(tmp_path / 'flags'),
                       '--device', 'cpu'])
  got = open(os.path.join(str(tmp_path / 'gin'), 'results.csv')).read()
  want = open(os.path.join(str(tmp_path / 'flags'), 'results.csv')).read()
  assert got == want
  assert got.splitlines()[0] == 'key, l1, psnr' and len(got.splitlines()) == 4
  with pytest.raises(ValueError, match='--tfrecord or --gin_config'):
    eval_benchmark.main(['--params', bundle, '--output_dir',
                         str(tmp_path / 'none'), '--device', 'cpu'])
