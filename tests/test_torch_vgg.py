"""The PyTorch port's VGG-19 and its losses against the JAX package's.

A small-channel MatConvNet-layout .mat (tests/test_losses.py's layout,
written here by the port's own copy of its writer, with scipy) exercises
the real loader; the tower, vgg_loss, style_loss (default weights, custom
weights, a mask), their gradient with respect to the image, and a
tiny-config film_net-Style train step's loss are held against JAX on the
same numpy inputs. Three JAX compiles: the losses and their gradient, the
pool, and the train step's loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.losses import vgg19 as jax_vgg19
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.losses import vgg19
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import configs, train_lib

pytest.importorskip('scipy.io')

torch.set_num_threads(2)

# Small-channel VGG-19: channels per conv layer, in tower order.
_CHANNELS = (8, 8, 12, 12, 16, 16, 16, 16, 24, 24, 24, 24, 24, 24)
_CUSTOM_WEIGHTS = (0.5, 1.5, 0.25, 2.0, 3.0)


def _write_fake_vgg_mat(path: str, seed: int = 0, channels=_CHANNELS):
  """A MatConvNet .mat of seeded conv weights at the VGG-19 conv slots
  (vgg19.save_vgg_weights); returns the (HWIO kernel, bias) pairs."""
  rng = np.random.RandomState(seed)
  cin, kernels = 3, []
  for cout in channels:
    kernel = (rng.randn(3, 3, cin, cout) * (9 * cin)**-0.5).astype(
        np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    kernels.append((kernel, bias))
    cin = cout
  vgg19.save_vgg_weights(path, kernels)
  return kernels


@pytest.fixture(scope='module')
def vgg_mat(tmp_path_factory):
  path = str(tmp_path_factory.mktemp('vgg') / 'fake_vgg19.mat')
  return path, _write_fake_vgg_mat(path)


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_loader_equals_jax(vgg_mat):
  path, kernels = vgg_mat
  ours = vgg19.load_vgg_weights(path)
  theirs = jax_vgg19._load_vgg_weights(path)
  assert len(ours) == len(theirs) == 14
  for (k, b), (jk, jb), (wk, wb) in zip(ours, theirs, kernels):
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_array_equal(b, wb)
  # The tower's constants: OIHW, no gradient, cached per (file, device).
  weights = vgg19._tower_weights(path, torch.device('cpu'))
  assert weights is vgg19._tower_weights(path, torch.device('cpu'))
  assert all(not w.requires_grad and not b.requires_grad
             for w, b in weights)
  assert tuple(weights[0][0].shape) == (8, 3, 3, 3)


def test_avg_pool_same_on_odd_sizes():
  x = np.random.RandomState(0).rand(2, 7, 9, 4).astype(np.float32)
  want = jax.jit(jax_vgg19._avg_pool_same)(jnp.asarray(x))
  got = vgg19.avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
  got = got.permute(0, 2, 3, 1).numpy()
  assert got.shape == want.shape == (2, 4, 5, 4)
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope='module')
def jax_results(vgg_mat):
  """JAX's features, losses and image gradient in one compile."""
  path, _ = vgg_mat
  rng = np.random.RandomState(1)
  image = rng.rand(2, 33, 41, 3).astype(np.float32)
  reference = rng.rand(2, 33, 41, 3).astype(np.float32)
  mask = rng.rand(2, 33, 41, 1).astype(np.float32)

  def run(image, reference, mask):
    def both(im):
      return (jax_vgg19.vgg_loss(im, reference, path) +
              jax_vgg19.style_loss(im, reference, path))
    return {
        'features': jax_vgg19.vgg_features(image * 255.0, path),
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


def test_features_match_jax_at_every_layer(vgg_mat, jax_results):
  path, _ = vgg_mat
  image = torch.from_numpy(jax_results['image'])
  feats = vgg19.vgg_features(image * 255.0, path)
  assert list(feats) == list(vgg19._CONV_NAMES)
  for name, value in feats.items():
    got = value.permute(0, 2, 3, 1).numpy()
    want = jax_results['features'][name]
    assert got.shape == want.shape, name
    assert _rel(got, want) <= 1e-5, name


@pytest.mark.parametrize('case', ['vgg', 'style', 'vgg_custom',
                                  'style_custom', 'vgg_mask', 'style_mask'])
def test_losses_match_jax(case, vgg_mat, jax_results):
  path, _ = vgg_mat
  fn = vgg19.vgg_loss if case.startswith('vgg') else vgg19.style_loss
  kwargs = {}
  if case.endswith('custom'):
    kwargs['weights'] = _CUSTOM_WEIGHTS
  if case.endswith('mask'):
    kwargs['mask'] = torch.from_numpy(jax_results['mask'])
  got = float(fn(torch.from_numpy(jax_results['image']),
                 torch.from_numpy(jax_results['reference']), path, **kwargs))
  want = float(jax_results[case])
  assert want > 0 and abs(got - want) <= 1e-5 * want, (got, want)


def test_image_gradient_matches_jax(vgg_mat, jax_results):
  path, _ = vgg_mat
  image = torch.from_numpy(jax_results['image']).requires_grad_()
  reference = torch.from_numpy(jax_results['reference'])
  loss = (vgg19.vgg_loss(image, reference, path) +
          vgg19.style_loss(image, reference, path))
  loss.backward()
  assert _rel(image.grad.numpy(), jax_results['grad']) <= 1e-4


def test_style_train_step_loss_matches_jax(vgg_mat):
  """A tiny-config l1 + vgg + style step at step 1,500,001 (vgg weighs
  0.25, style 40): the port's training_loss equals JAX's weighted loss."""
  path, _ = vgg_mat
  step = 1500001
  config = configs.get_experiment('film_net-Style', path)
  jax_config = config.training_losses
  options = Options.tiny()
  rng = np.random.RandomState(3)
  state = {}
  for name, value in film_net.create_model(options).state_dict().items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in**-0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  batch = {k: rng.rand(2, 32, 32, 3).astype(np.float32)
           for k in ('x0', 'x1', 'y')}
  batch['time'] = np.full((2, 1), 0.5, np.float32)

  jax_train = jax_losses.training_losses(
      list(jax_config.names),
      loss_weight_schedules=[jax_losses.PiecewiseConstantSchedule(
          s.boundaries, s.values) for s in jax_config.weight_schedules],
      vgg_model_file=path)
  jax_model = jax_film_net.create_model(JaxOptions.tiny())

  def jax_loss(params):
    prediction = jax_model.apply({'params': params}, batch['x0'],
                                 batch['x1'], batch['time'])
    return jax_losses.compute_weighted_loss(jax_train, batch, prediction,
                                            step)

  want = float(jax.jit(jax_loss)(params_io.to_flax_params(state)))

  train = losses.training_losses(
      list(jax_config.names),
      loss_weight_schedules=list(jax_config.weight_schedules),
      vgg_model_file=path)
  assert list(train) == ['l1', 'k*vgg', 'k*style']
  assert [w(step) for _, w in train.values()] == [1.0, 0.25, 40.0]
  model = film_net.create_model(options)
  model.load_state_dict(state)
  train_state = train_lib.create_train_state(model,
                                             train_lib.TrainingOptions())
  train_state.step = step
  step_fn = train_lib.make_train_step(train, train_lib.TrainingOptions(),
                                      with_summaries=False)
  metrics, _ = step_fn(train_state,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.Generator().manual_seed(0))
  got = float(metrics['training_loss'])
  assert metrics['k*style'] > 0 and metrics['k*vgg'] > 0
  assert abs(got - want) <= 1e-5 * want, (got, want)
