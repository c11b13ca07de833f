"""The plain reference against the port on the CPU at tiny sizes, and the
controls: the reference one precision below the configuration's, in the
program's place, fails the cell's limits."""
import dataclasses

import numpy as np
import pytest
import torch

from film_bench import bench, weights
from film_bench.reference import film_net as ref
from film_bench.reference import lowp
from film_bench.reference import training as ref_training
from film_bench.tests import helpers


@pytest.fixture
def tiny_model():
  from frame_interpolation_tpu_torch.models.film_net import FilmNet
  from frame_interpolation_tpu_torch.options import Options
  options = Options.tiny()
  shapes = ref.parameter_shapes(dataclasses.asdict(options))
  params = weights.film_net(shapes, 5, 'cpu')
  generator = torch.Generator().manual_seed(5)
  for k in params:  # biases too, so that they are tested
    if k.endswith('bias'):
      params[k] = 0.1 * torch.randn(params[k].shape, generator=generator)
  model = FilmNet(options)
  model.load_state_dict(params)
  return model, params, dataclasses.asdict(options)


def test_parameters_are_the_ports(tiny_model):
  model, params, _ = tiny_model
  assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
      k: tuple(v.shape) for k, v in params.items()}
  assert list(model.state_dict()) == list(params)


def test_forward_is_the_ports(tiny_model):
  model, params, options = tiny_model
  g = torch.Generator().manual_seed(1)
  x0, x1 = torch.rand(2, 2, 40, 56, 3, generator=g)
  with torch.no_grad():
    want = model(x0, x1, torch.full((2, 1), 0.5))['image']
    got = ref.forward(params, options, x0.permute(0, 3, 1, 2),
                      x1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
  assert (got - want).abs().max() < 1e-5


def test_padding_is_the_interpolators(tiny_model):
  from frame_interpolation_tpu_torch.inference import Interpolator
  model, params, options = tiny_model
  frames = np.random.RandomState(0).randint(0, 256, (2, 1, 30, 45, 3),
                                            np.uint8)
  want = Interpolator(model, model.options, align=8, device='cpu')(
      frames[0], frames[1], np.full((1,), 0.5, np.float32))
  x0, x1 = (torch.from_numpy(f.astype(np.float32) / np.float32(255)).permute(
      0, 3, 1, 2) for f in frames)
  got = ref.interpolate(params, options, x0, x1, 8).permute(0, 2, 3, 1)
  assert np.abs(got.detach().numpy() - want).max() < 1e-5


def test_augmentations_are_the_ports():
  from frame_interpolation_tpu_torch.data import augmentations
  names = ('random_image_rot90', 'random_flip', 'random_rotate',
           'random_reverse')
  g = torch.Generator().manual_seed(3)
  batch = {k: torch.rand(6, 16, 16, 3, generator=g) for k in ('x0', 'x1', 'y')}
  want = augmentations.augment_batch(torch.Generator().manual_seed(11),
                                     dict(batch), names)
  nchw = {k: v.permute(0, 3, 1, 2) for k, v in batch.items()}
  got = ref_training.augment(
      nchw, ref_training.draw(torch.Generator().manual_seed(11), 6))
  for k in ('x0', 'x1', 'y'):
    assert (got[k].permute(0, 2, 3, 1) - want[k]).abs().max() < 1e-5


def test_adam_is_torchs():
  g = torch.Generator().manual_seed(2)
  p = {'w': torch.randn(5, 3, generator=g)}
  torch_p = torch.nn.Parameter(p['w'].clone())
  adam = torch.optim.Adam([torch_p], lr=1e-3, eps=1e-7)
  mine = ref_training.Adam(p)
  for _ in range(3):
    grad = torch.randn(5, 3, generator=g)
    torch_p.grad = grad.clone()
    adam.step()
    mine.update(p, {'w': grad}, 1e-3)
  assert (p['w'] - torch_p.detach()).abs().max() < 1e-7


@pytest.mark.parametrize('cell', ['pair-1080p', 'video-1080p-t3',
                                  'train-style-256'])
def test_a_tiny_run_is_correct(cell, tiny_vgg):
  ctx = helpers.context(cell, seconds=2.0)
  outcome, checks = helpers.drive(ctx)
  assert outcome['attempted'] > 0 and outcome['failed'] == 0
  for name, value, limit in checks:
    assert value <= limit, (name, value, limit)


def test_the_train_reference_follows_the_port(tiny_vgg):
  # Float32 on the CPU, the same arithmetic: the steps' losses, their
  # gradients (the first and each later one from the program's state) and
  # the change agree to rounding.
  ctx = helpers.context('train-style-256', seconds=0.5)
  driver = bench.load_driver('train_step').Driver(ctx)
  driver.setup()
  driver.window()
  driver.release()
  driver.check()
  for name in ('first_loss_gap', 'later_loss_gap', 'replay_loss_gap',
               'grad_norm_gap', 'replay1_grad_norm_gap_median',
               'replay2_grad_norm_gap_median', 'change_norm_gap'):
    assert driver.readings[name] < 1e-5, (name, driver.readings)


@pytest.mark.parametrize('cell', ['pair-1080p', 'video-1080p-t3',
                                  'train-style-256'])
def test_the_control_is_not_correct(cell, tiny_vgg):
  """The reference one precision below the configuration's, in the
  program's place, fails at least one of the cell's numbers (at a test's
  size)."""
  ctx = helpers.context(cell, seconds=2.0)
  driver = bench.load_driver(ctx.workload['entry']).Driver(ctx)
  driver.setup()
  driver.window()
  driver.release()
  checks = driver.check(quant=lowp.BELOW[ctx.config['precision']])
  assert any(value > limit for _, value, limit in checks), checks


@pytest.mark.card
def test_the_train_check_holds_each_precision_to_its_reference(card):
  """The training check holds the program to a reference of the precision
  its configuration states: the program in exact f32 passes against the
  exact reference, the program as configured (cuDNN and the port's conv in
  TF32) against the reference's TF32 convs, and the program's own bf16
  path, one precision below, fails. On the card (TF32 exists only there),
  at the cell's own sizes."""
  from film_bench import controls
  workload = bench.load_json('workloads', 'train-style-256')
  config = bench.load_json('configs', workload['config'])
  exact = {'cudnn_allow_tf32': False, 'matmul_allow_tf32': False}
  for overrides, correct in ((exact, True), ({}, True),
                             (config['program_control'], False)):
    ctx = bench.Context(workload['name'], workload,
                        controls.overridden(config, overrides), 2**31 + 41,
                        0.5, False, card, 0.0)
    driver = bench.load_driver('train_step').Driver(ctx)
    driver.setup()
    driver.window()
    driver.release()
    checks = driver.check()
    assert all(v <= limit for _, v, limit in checks) == correct, (
        overrides, checks)
    del driver
    torch.cuda.empty_cache()
