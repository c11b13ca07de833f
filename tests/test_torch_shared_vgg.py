"""Shared VGG-19 towers: one tower per image for every perceptual loss.

Under `jax.jit` XLA merges the identical `vgg_features` calls of the vgg
and style losses, so the JAX package's Style step runs one tower per
image. The port does it with `vgg19.shared_features()`, which the train
step, `losses.compute_weighted_loss` and eval's metrics open. Held here,
with a counter on `vgg19.vgg_features`: a film_net-Style objective, train
step and eval batch (its training loss and its vgg and style test losses)
each run the tower twice, the prediction's with grad in a step and the
reference's without; each loss in a scope equals its value outside one
within 1e-6 relative, and JAX's within test_torch_vgg.py's 1e-5; the
image gradient equals JAX's within 1e-4; slices of one batch get towers
of their own; the scope ends with its call. Three JAX compiles: the
losses and their gradient, and eval's forward and metrics.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.losses import vgg19 as jax_vgg19
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.training import eval_lib as jax_eval_lib
from frame_interpolation_tpu.training import metrics_lib as jax_metrics_lib
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.losses import vgg19
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import (configs, eval_lib,
                                                    metrics_lib, train_lib)

pytest.importorskip('scipy.io')

torch.set_num_threads(2)

_CHANNELS = (8, 8, 12, 12, 16, 16, 16, 16, 24, 24, 24, 24, 24, 24)
_CUSTOM_WEIGHTS = (0.5, 1.5, 0.25, 2.0, 3.0)
# A loss in a scope against the same loss outside one: the same ops on the
# same inputs.
SHARED_REL_BOUND = 1e-6
# Against JAX: test_torch_vgg.py's bounds.
JAX_LOSS_REL_BOUND, JAX_GRAD_REL_BOUND = 1e-5, 1e-4
# Eval's means against JAX's: test_torch_eval.py's bound.
EVAL_REL_BOUND = 1e-4
# Gradients of one objective in a scope and outside: the vgg and style
# cotangents meet at the features and go down one tower, so only the
# order of the f32 sums changes.
GRAD_ORDER_REL_BOUND = 1e-5
STYLE_STEP = 1500001  # vgg weighs 0.25, style 40


@pytest.fixture(scope='module')
def vgg_path(tmp_path_factory):
  rng = np.random.RandomState(0)
  cin, kernels = 3, []
  for cout in _CHANNELS:
    kernels.append(((rng.randn(3, 3, cin, cout) * (9 * cin)**-0.5).astype(
        np.float32), (rng.randn(cout) * 0.1).astype(np.float32)))
    cin = cout
  path = str(tmp_path_factory.mktemp('vgg') / 'fake_vgg19.mat')
  vgg19.save_vgg_weights(path, kernels)
  return path


@pytest.fixture
def towers(monkeypatch):
  """Records the grad mode of every vgg_features call."""
  calls = []
  original = vgg19.vgg_features

  def counted(image, model_filepath):
    calls.append(torch.is_grad_enabled())
    return original(image, model_filepath)

  monkeypatch.setattr(vgg19, 'vgg_features', counted)
  return calls


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _tiny_state(seed):
  rng = np.random.RandomState(seed)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in**-0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


def _tiny_model(seed=3):
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(_tiny_state(seed))
  return model


def _batch(seed, n=2, h=32, w=32):
  rng = np.random.RandomState(seed)
  batch = {k: rng.rand(n, h, w, 3).astype(np.float32)
           for k in ('x0', 'x1', 'y')}
  batch['time'] = np.full((n, 1), 0.5, np.float32)
  return batch


def _style_losses(path):
  config = configs.get_experiment('film_net-Style', path).training_losses
  return losses.training_losses(
      list(config.names), loss_weight_schedules=list(config.weight_schedules),
      vgg_model_file=path)


@pytest.fixture(scope='module')
def jax_results(vgg_path):
  """JAX's losses and image gradient in one compile."""
  rng = np.random.RandomState(1)
  image = rng.rand(2, 33, 41, 3).astype(np.float32)
  reference = rng.rand(2, 33, 41, 3).astype(np.float32)
  mask = rng.rand(2, 33, 41, 1).astype(np.float32)
  path = vgg_path

  def run(image, reference, mask):
    def both(im):
      return (jax_vgg19.vgg_loss(im, reference, path) +
              jax_vgg19.style_loss(im, reference, path))
    return {
        'vgg': jax_vgg19.vgg_loss(image, reference, path),
        'style': jax_vgg19.style_loss(image, reference, path),
        'vgg_custom': jax_vgg19.vgg_loss(image, reference, path,
                                         _CUSTOM_WEIGHTS),
        'style_custom': jax_vgg19.style_loss(image, reference, path,
                                             _CUSTOM_WEIGHTS),
        'vgg_mask': jax_vgg19.vgg_loss(image, reference, path, mask=mask),
        'style_mask': jax_vgg19.style_loss(image, reference, path,
                                           mask=mask),
        'grad': jax.grad(both)(image),
    }

  out = jax.device_get(jax.jit(run)(image, reference, mask))
  return {'image': image, 'reference': reference, 'mask': mask, **out}


def _loss_kwargs(case, jax_results):
  kwargs = {}
  if case.endswith('custom'):
    kwargs['weights'] = _CUSTOM_WEIGHTS
  if case.endswith('mask'):
    kwargs['mask'] = torch.from_numpy(jax_results['mask'])
  return kwargs


@pytest.mark.parametrize('case', ['vgg', 'style', 'vgg_custom',
                                  'style_custom', 'vgg_mask', 'style_mask'])
def test_shared_loss_equals_unshared_and_jax(case, vgg_path, jax_results,
                                             towers):
  # In a scope the other loss runs first and fills the cache; the case's
  # loss then reads its towers.
  image = torch.from_numpy(jax_results['image'])
  reference = torch.from_numpy(jax_results['reference'])
  kwargs = _loss_kwargs(case, jax_results)
  fn, other = ((vgg19.vgg_loss, vgg19.style_loss) if case.startswith('vgg')
               else (vgg19.style_loss, vgg19.vgg_loss))
  unshared = float(fn(image, reference, vgg_path, **kwargs))
  assert len(towers) == 2
  with vgg19.shared_features():
    other(image, reference, vgg_path, **kwargs)
    shared = float(fn(image, reference, vgg_path, **kwargs))
  assert len(towers) == 4
  want = float(jax_results[case])
  assert abs(shared - unshared) <= SHARED_REL_BOUND * abs(unshared)
  assert want > 0 and abs(shared - want) <= JAX_LOSS_REL_BOUND * want, (
      shared, want)


def test_shared_image_gradient_matches_jax(vgg_path, jax_results, towers):
  reference = torch.from_numpy(jax_results['reference'])
  grads = {}
  for shared in (False, True):
    image = torch.from_numpy(jax_results['image']).requires_grad_()
    with vgg19.shared_features() if shared else contextlib.nullcontext():
      loss = (vgg19.vgg_loss(image, reference, vgg_path) +
              vgg19.style_loss(image, reference, vgg_path))
    loss.backward()
    grads[shared] = image.grad.numpy()
  # Four towers unshared, two shared: the image's with grad, the
  # reference's without.
  assert towers == [False, True, False, True] + [False, True]
  assert _rel(grads[True], jax_results['grad']) <= JAX_GRAD_REL_BOUND
  assert _rel(grads[True], grads[False]) <= GRAD_ORDER_REL_BOUND


def test_style_objective_runs_one_tower_an_image(vgg_path, towers):
  # compute_weighted_loss's shared form against the same sum outside a
  # scope: the value within 1e-6, the model's gradients within the sum
  # order's bound.
  style = _style_losses(vgg_path)
  batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
  results = {}
  for shared in (True, False):
    model = _tiny_model()
    prediction = model(batch['x0'], batch['x1'], batch['time'])
    del towers[:]
    if shared:
      total = losses.compute_weighted_loss(style, batch, prediction,
                                           STYLE_STEP)
    else:
      total = sum(weight_fn(STYLE_STEP) * loss_fn(batch, prediction)
                  for loss_fn, weight_fn in style.values())
    total.backward()
    results[shared] = (float(total.detach()), list(towers),
                       [p.grad.numpy().copy() for p in model.parameters()
                        if p.grad is not None])
  value, calls, grads = results[True]
  assert sorted(calls) == [False, True]
  assert results[False][1] == [False, True, False, True]
  assert abs(value - results[False][0]) <= SHARED_REL_BOUND * abs(value)
  assert len(grads) == len(results[False][2]) > 0
  for got, want in zip(grads, results[False][2]):
    assert _rel(got, want) <= GRAD_ORDER_REL_BOUND


def test_style_train_step_runs_one_tower_an_image(vgg_path, towers):
  # The tiny-config Style step: two towers, and its training loss equals
  # the unshared objective on the same weights and batch (no
  # augmentations). Two steps from one state under deterministic
  # algorithms are bit-equal.
  style = _style_losses(vgg_path)
  batch = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
  model = _tiny_model()
  with torch.no_grad():
    prediction = model(batch['x0'], batch['x1'], batch['time'])
    want = float(sum(weight_fn(STYLE_STEP) * loss_fn(batch, prediction)
                     for loss_fn, weight_fn in style.values()))
  params = []
  saved = torch.are_deterministic_algorithms_enabled()
  torch.use_deterministic_algorithms(True)
  try:
    for _ in range(2):
      model = _tiny_model()
      state = train_lib.create_train_state(model, train_lib.TrainingOptions())
      state.step = STYLE_STEP
      step_fn = train_lib.make_train_step(style, train_lib.TrainingOptions(),
                                          with_summaries=False)
      del towers[:]
      metrics, _ = step_fn(state, batch, torch.Generator().manual_seed(0))
      assert sorted(towers) == [False, True]
      got = float(metrics['training_loss'])
      assert abs(got - want) <= SHARED_REL_BOUND * abs(want), (got, want)
      params.append([p.detach().clone() for p in model.parameters()])
  finally:
    torch.use_deterministic_algorithms(saved)
  assert all(torch.equal(a, b) for a, b in zip(*params))


def test_eval_batch_runs_one_tower_an_image_and_matches_jax(vgg_path, towers):
  # One batch of eval with film_net-Style's training loss and vgg and
  # style test losses: two towers (both without grad, under inference
  # mode); the means equal the metrics outside a scope and JAX's.
  test_names, test_weights = ['l1', 'vgg', 'style'], [1.0, 0.5, 2.0]
  ours = metrics_lib.create_metrics_fns(
      losses.test_losses(test_names, loss_weights=test_weights,
                         vgg_model_file=vgg_path),
      _style_losses(vgg_path))
  config = configs.get_experiment('film_net-Style', vgg_path).training_losses
  theirs = jax_metrics_lib.create_metrics_fns(
      jax_losses.test_losses(test_names, loss_weights=test_weights,
                             vgg_model_file=vgg_path),
      jax_losses.training_losses(
          list(config.names),
          loss_weight_schedules=[jax_losses.PiecewiseConstantSchedule(
              s.boundaries, s.values) for s in config.weight_schedules],
          vgg_model_file=vgg_path))
  datasets = {'a': [_batch(7, h=32, w=48)]}
  state = _tiny_state(4)
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(state)
  got = eval_lib.eval_loop(model, datasets, ours, STYLE_STEP,
                           log_fn=lambda _: None, graphs=False)['a']
  assert towers == [False, False]
  example = train_lib.batch_to_device(datasets['a'][0], torch.device('cpu'))
  with torch.inference_mode():
    prediction = model(example['x0'], example['x1'], example['time'])
    unshared = {name: float(fn(example, prediction, STYLE_STEP))
                for name, fn in ours.items()}
  assert len(towers) == 2 + 2 * 3  # training_loss 4, vgg 2, style 2
  want = jax_eval_lib.eval_loop(
      jax_film_net.FilmNet(JaxOptions.tiny()),
      params_io.to_flax_params(state), datasets, theirs, STYLE_STEP,
      log_fn=lambda _: None)['a']
  assert list(got) == list(ours) and sorted(want) == sorted(ours)
  for name, value in want.items():
    assert abs(got[name] - unshared[name]) <= SHARED_REL_BOUND * abs(
        unshared[name]), name
    assert abs(got[name] - value) <= EVAL_REL_BOUND * abs(value), name


def test_slices_of_one_batch_get_towers_of_their_own(vgg_path, towers):
  # The data-parallel step slices the batch before the losses: each
  # slice is its own input, so its own tower, inside one scope.
  rng = np.random.RandomState(8)
  image = torch.from_numpy(rng.rand(4, 24, 24, 3).astype(np.float32))
  reference = torch.from_numpy(rng.rand(4, 24, 24, 3).astype(np.float32))
  halves = [(image[i:i + 2], reference[i:i + 2]) for i in (0, 2)]
  want = [(float(vgg19.vgg_loss(x, y, vgg_path)),
           float(vgg19.style_loss(x, y, vgg_path))) for x, y in halves]
  del towers[:]
  with vgg19.shared_features():
    got = [(float(vgg19.vgg_loss(x, y, vgg_path)),
            float(vgg19.style_loss(x, y, vgg_path))) for x, y in halves]
  assert len(towers) == 4
  assert got == want


def test_the_scope_ends_with_its_call(vgg_path, towers):
  rng = np.random.RandomState(9)
  image, reference = (torch.from_numpy(rng.rand(1, 16, 16, 3).astype(
      np.float32)) for _ in range(2))
  with vgg19.shared_features():
    with vgg19.shared_features():  # joins the outer scope
      vgg19.vgg_loss(image, reference, vgg_path)
    vgg19.style_loss(image, reference, vgg_path)
  assert len(towers) == 2
  with pytest.raises(RuntimeError):
    with vgg19.shared_features():
      vgg19.vgg_loss(image, reference, vgg_path)
      raise RuntimeError('a failing loss')
  assert len(towers) == 4
  # Outside a scope each call runs its own towers again.
  vgg19.vgg_loss(image, reference, vgg_path)
  vgg19.style_loss(image, reference, vgg_path)
  assert len(towers) == 8
