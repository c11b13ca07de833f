"""The PyTorch port's training slice against the JAX package's, on the CPU.

One train step of the tiny config (f32): the port's loss and gradients,
through torch autograd and the port's warp and conv Functions, against
`jax.value_and_grad` of the JAX FilmNet with the same weights (carried
through io/params_io) and the same numpy inputs. Then the optimizer and
schedule against optax, the losses and schedules against the JAX losses,
the presets, and the port's train loop (checkpoints, resume, summaries,
export). On CPU tensors the port runs the plain versions of its kernels;
the kernels' route is exercised with stand-ins that run the plain versions
without autograd, as the ctypes kernels run.
"""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.training import configs as jax_configs
from frame_interpolation_tpu.training import sources as jax_sources
from frame_interpolation_tpu.training import train_lib as jax_train_lib
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.data import augmentations
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.losses import vgg19
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.ops import conv_stack, warp
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import configs, sources
from frame_interpolation_tpu_torch.training import train_lib

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

H = W = 32


def _numpy_state(options, seed=0):
  """Seeded numpy weights (lecun-normal scale, zero biases, as init)."""
  rng = np.random.RandomState(seed)
  state = {}
  for name, value in film_net.create_model(options).state_dict().items():
    if value.dim() == 4:
      fan_in = int(np.prod(value.shape[1:]))
      array = rng.randn(*value.shape) * fan_in**-0.5
    else:
      array = np.zeros(value.shape)
    state[name] = torch.from_numpy(array.astype(np.float32))
  return state


def _batch(seed=0, n=2):
  """Frames with exact-zero regions: noise rotated by 30 degrees (its
  corners filled with 0, as random_rotate fills) and a zeroed band."""
  rng = np.random.RandomState(seed)
  frames = {}
  for key in ('x0', 'x1', 'y'):
    noise = torch.from_numpy(rng.rand(n, H, W, 3).astype(np.float32))
    rotated = augmentations.rotate_image(noise, np.pi / 6).numpy()
    rotated[:, :, :6] = 0.0
    frames[key] = rotated
  frames['time'] = np.full((n, 1), 0.5, np.float32)
  return frames


def _port_loss_and_grads(model, batch):
  tb = {k: torch.from_numpy(v) for k, v in batch.items()}
  model.zero_grad(set_to_none=True)
  out = model(tb['x0'], tb['x1'], tb['time'])
  loss = losses.l1_loss(tb, out)
  loss.backward()
  return loss.item(), {n: p.grad.numpy().copy()
                       for n, p in model.named_parameters()}


@pytest.fixture(scope='module')
def step_case():
  options = Options.tiny()
  state = _numpy_state(options)
  batch = _batch()
  jax_model = jax_film_net.create_model(JaxOptions.tiny())
  params = params_io.to_flax_params(state)

  def loss_fn(params):
    out = jax_model.apply({'params': params}, batch['x0'], batch['x1'],
                          batch['time'])
    return jax_losses.l1_loss(batch, out)

  jax_loss, jax_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
  want = params_io.from_flax_params(jax.device_get(jax_grads))
  model = film_net.create_model(options)
  model.load_state_dict(state)
  return {'options': options, 'state': state, 'batch': batch,
          'model': model, 'jax_loss': float(jax_loss),
          'jax_grads': {k: v.numpy() for k, v in want.items()}}


def _assert_grads_close(got, want, rtol):
  assert set(got) == set(want)
  for name, g in got.items():
    scale = float(np.abs(want[name]).max())
    err = float(np.abs(g - want[name]).max())
    assert err <= rtol * scale, (name, err, scale)


def test_train_step_loss_and_grads_match_jax(step_case):
  assert (step_case['batch']['x0'] == 0).mean() > 0.2  # the zero regions
  loss, grads = _port_loss_and_grads(step_case['model'], step_case['batch'])
  assert abs(loss - step_case['jax_loss']) <= 1e-5 * step_case['jax_loss']
  _assert_grads_close(grads, step_case['jax_grads'], 1e-4)


def _kernel_route(monkeypatch):
  """Routes the model's warps and kernel convs through the autograd
  Functions with plain=False, each kernel stood in for by its plain
  version run without autograd (as the ctypes kernels run)."""
  calls = {'warp': 0, 'warp_planes': 0, 'splat': 0, 'conv': 0}

  def no_grad(name, fn):
    def stand_in(*args, **kwargs):
      calls[name] += 1
      with torch.no_grad():
        return fn(*args, **kwargs)
    return stand_in

  monkeypatch.setattr(warp, 'backward_warp_kernel',
                      no_grad('warp', warp.backward_warp_plain))
  monkeypatch.setattr(warp, 'warp_planes_kernel',
                      no_grad('warp_planes', warp.warp_planes_plain))
  monkeypatch.setattr(warp, 'splat_kernel',
                      no_grad('splat', warp.splat_plain))
  monkeypatch.setattr(conv_stack, 'conv3x3_leaky_kernel',
                      no_grad('conv', conv_stack.conv3x3_leaky_plain))
  monkeypatch.setattr(
      warp, 'backward_warp',
      lambda image, flow: warp.BackwardWarp.apply(image, flow, False))

  def conv(x, weight, bias, pool=False, negative_slope=0.2):
    out = conv_stack.Conv3x3Leaky.apply(x, weight, bias, pool,
                                        negative_slope, False)
    return out if pool else (out, None)

  monkeypatch.setattr(conv_stack, 'conv3x3_leaky', conv)
  return calls


def test_kernel_route_gives_every_parameter_its_gradient(step_case,
                                                         monkeypatch):
  # What a CUDA model runs: the kernels write fresh tensors without
  # autograd history, so every gradient upstream of a warp or a kernel conv
  # must come from the Functions. It equals the plain route's.
  want = _port_loss_and_grads(step_case['model'], step_case['batch'])
  calls = _kernel_route(monkeypatch)
  loss, grads = _port_loss_and_grads(step_case['model'], step_case['batch'])
  # Tiny config: 3 + 3 flow-estimator warps, 3 + 3 fusion warps; per frame
  # 3 + 3 + 2 + 1 second convs (subtree depths by image level) and 2 first
  # convs (sub-level 2 of the two deepest subtrees).
  assert calls == {'warp': 12, 'warp_planes': 12, 'splat': 12, 'conv': 22}
  assert loss == want[0]
  for name, g in grads.items():
    assert np.isfinite(g).all() and np.abs(g).max() > 0, name
    np.testing.assert_array_equal(g, want[1][name], err_msg=name)


# ---- optimizer and schedule -------------------------------------------------


def test_adam_and_staircase_schedule_match_optax():
  kwargs = dict(learning_rate=1e-2, learning_rate_decay_steps=3,
                learning_rate_decay_rate=0.464158,
                learning_rate_staircase=True)
  rng = np.random.RandomState(0)
  init = {'a': rng.randn(3, 4).astype(np.float32),
          'b': rng.randn(5).astype(np.float32)}
  grads = [{k: rng.randn(*v.shape).astype(np.float32)
            for k, v in init.items()} for _ in range(8)]

  jax_opt = jax_train_lib.create_optimizer(
      jax_train_lib.TrainingOptions(**kwargs))
  jax_params = {k: jnp.asarray(v) for k, v in init.items()}
  jax_state = jax_opt.init(jax_params)

  opts = train_lib.TrainingOptions(**kwargs)
  params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in init.items()}
  optimizer = train_lib.create_optimizer(list(params.values()), opts)
  schedule = train_lib.learning_rate_schedule(opts)
  jax_schedule = jax_train_lib.learning_rate_schedule(
      jax_train_lib.TrainingOptions(**kwargs))
  for step, g in enumerate(grads):
    assert abs(schedule(step) - float(jax_schedule(step))) <= 1e-9
    updates, jax_state = jax_opt.update({k: jnp.asarray(v)
                                         for k, v in g.items()},
                                        jax_state, jax_params)
    jax_params = optax.apply_updates(jax_params, updates)
    for k, p in params.items():
      p.grad = torch.from_numpy(g[k])
    train_lib.set_learning_rate(optimizer, schedule(step))
    optimizer.step()
    for k, p in params.items():
      np.testing.assert_allclose(p.detach().numpy(), jax_params[k],
                                 atol=1e-6, err_msg=f'{k} step {step}')


def test_schedule_matches_jax_at_the_released_boundaries():
  ours = train_lib.learning_rate_schedule(train_lib.TrainingOptions())
  theirs = jax_train_lib.learning_rate_schedule(
      jax_train_lib.TrainingOptions())
  for step in [0, 1, 749999, 750000, 1500000, 2999999]:
    np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)


# ---- losses -----------------------------------------------------------------


@pytest.mark.parametrize('name', ['l1', 'l2', 'l1_warped', 'ssim', 'psnr'])
def test_losses_match_jax(name):
  rng = np.random.RandomState(3)
  example = {'y': rng.rand(2, 24, 20, 3).astype(np.float32)}
  prediction = {k: rng.rand(2, 24, 20, 3).astype(np.float32)
                for k in ('image', 'x0_warped', 'x1_warped')}
  want = float(jax_losses.get_loss(name)(example, prediction))
  got = float(losses.get_loss(name)(
      {k: torch.from_numpy(v) for k, v in example.items()},
      {k: torch.from_numpy(v) for k, v in prediction.items()}))
  assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_weighted_losses_and_schedules_match_jax():
  schedules = [losses.PiecewiseConstantSchedule((10,), (1.0, 0.25)),
               losses.constant_schedule(1.0),
               losses.PiecewiseConstantSchedule((0, 20), (0.0, 2.0, 40.0))]
  jax_schedules = [jax_losses.PiecewiseConstantSchedule(s.boundaries,
                                                        s.values)
                   for s in schedules]
  for step in (0, 1, 10, 11, 20, 21):
    for ours, theirs in zip(schedules, jax_schedules):
      assert ours(step) == float(theirs(step))
  names = ['l1', 'l2', 'l1_warped']
  ours = losses.training_losses(names, loss_weight_schedules=schedules)
  theirs = jax_losses.training_losses(names,
                                      loss_weight_schedules=jax_schedules)
  assert list(ours) == list(theirs) == ['k*l1', 'l2', 'k*l1_warped']
  rng = np.random.RandomState(4)
  example = {'y': rng.rand(1, 8, 8, 3).astype(np.float32)}
  prediction = {k: rng.rand(1, 8, 8, 3).astype(np.float32)
                for k in ('image', 'x0_warped', 'x1_warped')}
  for step in (0, 15, 25):
    want = float(jax_losses.compute_weighted_loss(theirs, example,
                                                  prediction, step))
    got = float(losses.compute_weighted_loss(
        ours, {k: torch.from_numpy(v) for k, v in example.items()},
        {k: torch.from_numpy(v) for k, v in prediction.items()}, step))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
  batches = [{'l1': 1.0, 'psnr': 30.0}, {'l1': 3.0, 'psnr': 20.0}]
  assert (losses.aggregate_batch_losses(batches) ==
          jax_losses.aggregate_batch_losses(batches))


@pytest.mark.parametrize('name', ['vgg', 'style'])
def test_perceptual_losses_wait_for_vgg19(name, tmp_path):
  # They need the weights file, as JAX's do, and compute with one.
  with pytest.raises(ValueError, match='needs vgg_model_file'):
    losses.get_loss(name)
  missing = str(tmp_path / 'imagenet-vgg-verydeep-19.mat')
  with pytest.raises(FileNotFoundError, match='no VGG-19 weights'):
    losses.get_loss(name, vgg_model_file=missing)
  path = str(tmp_path / 'vgg.mat')
  _write_vgg_mat(path)
  rng = np.random.RandomState(7)
  example = {'y': rng.rand(1, 20, 24, 3).astype(np.float32)}
  prediction = {'image': rng.rand(1, 20, 24, 3).astype(np.float32)}
  want = float(jax.jit(jax_losses.get_loss(name, path))(example, prediction))
  got = float(losses.get_loss(name, path)(
      {'y': torch.from_numpy(example['y'])},
      {'image': torch.from_numpy(prediction['image'])}))
  assert want > 0 and abs(got - want) <= 1e-5 * want


# ---- presets and sources ----------------------------------------------------


@pytest.mark.parametrize('name', ['film_net-L1', 'film_net-VGG',
                                  'film_net-Style'])
def test_presets_match_jax(name):
  ours = dataclasses.asdict(configs.get_experiment(name, 'vgg.mat'))
  theirs = dataclasses.asdict(jax_configs.get_experiment(name, 'vgg.mat'))
  model = ours.pop('model')
  jax_model = theirs.pop('model')
  assert ours == theirs
  assert all(jax_model[k] == v for k, v in model.items())
  assert configs.get_experiment('film_net-L1').model == (
      Options.film_net_released())


@pytest.mark.parametrize('flags', [
    dict(train_files=['a@2', 'b'], crop_sizes=['128', '256'],
         train_weights=['1', '3']),
    dict(train_file='c@4'),
    dict(config_files=('d', 'e'), config_crop_sizes=(64, 96)),
])
def test_training_sources_match_jax(flags):
  dataset = configs.DatasetConfig(files=flags.get('config_files', ()),
                                  crop_sizes=flags.get('config_crop_sizes',
                                                       ()))
  jax_dataset = jax_configs.DatasetConfig(**dataclasses.asdict(dataset))

  class Lib:
    class TrainingSource:

      def __init__(self, file, crop_size):
        self.pair = (file, crop_size)

  args = (flags.get('train_file'), flags.get('train_files', []),
          flags.get('crop_sizes', []), 256, flags.get('train_weights', []))
  ours, weights = sources.build_training_sources(Lib, dataset, *args)
  theirs, jax_weights = jax_sources.build_training_sources(Lib, jax_dataset,
                                                           *args)
  assert [s.pair for s in ours] == [s.pair for s in theirs]
  assert weights == jax_weights


# ---- the loop ---------------------------------------------------------------


def _constant_batches():
  batch = _batch(seed=5)
  while True:
    yield batch


def _train(run_dir, num_steps, save_interval=2):
  opts = train_lib.TrainingOptions(learning_rate=1e-3, num_steps=num_steps,
                                   save_interval=save_interval,
                                   timing_interval=1, max_to_keep=2)
  log = []
  state = train_lib.train(
      film_net.create_model(Options.tiny()), Options.tiny(),
      losses.training_losses(['l1']), _constant_batches(), opts,
      str(run_dir), device='cpu',
      augmentation_names=('random_image_rot90', 'random_flip',
                          'random_rotate', 'random_reverse'),
      log_fn=log.append)
  return state, log


def test_train_resume_equals_an_uninterrupted_run(tmp_path):
  straight, log = _train(tmp_path / 'straight', 4)
  assert straight.step == 4 and len(log) == 3  # steps 2, 4 and the export
  _train(tmp_path / 'resumed', 2)
  resumed, log = _train(tmp_path / 'resumed', 4)
  assert log[0] == 'Restored checkpoint at step 2'
  for (name, a), b in zip(straight.model.state_dict().items(),
                          resumed.model.state_dict().values()):
    torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
  ckpt = train_lib.CheckpointManager(str(tmp_path / 'resumed' / 'train'))
  assert ckpt.steps() == [2, 4]
  events = glob.glob(str(tmp_path / 'resumed' / 'train' / 'events.out.*'))
  assert len(events) == 2 and all(os.path.getsize(e) > 0 for e in events)


def test_checkpoints_keep_max_to_keep(tmp_path):
  _train(tmp_path, 5, save_interval=1)
  ckpt = train_lib.CheckpointManager(str(tmp_path / 'train'))
  assert ckpt.steps() == [4, 5] and ckpt.latest_step() == 5


def test_export_loads_into_the_interpolator(tmp_path):
  state, _ = _train(tmp_path, 2)
  state_dict, options = params_io.load_state_bundle(
      str(tmp_path / 'saved_model'))
  assert options == Options.tiny()
  for name, value in state.model.state_dict().items():
    torch.testing.assert_close(state_dict[name], value, rtol=0, atol=0)
  frames = _batch(seed=6, n=1)
  out = Interpolator(state_dict, options, align=16, device='cpu')(
      frames['x0'], frames['x1'], np.full((1,), 0.5, np.float32))
  assert out.shape == (1, H, W, 3) and np.isfinite(out).all()
