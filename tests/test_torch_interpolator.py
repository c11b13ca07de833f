"""The PyTorch port's Interpolator, CLI and image I/O, on the CPU.

The port's Interpolator is held against the JAX package's on the same
numpy weights and frames: an unaligned pair (pad -> forward -> crop) and a
2x2-tiled aligned pair (all patches as one batch).
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.io import images as jax_images
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch.cli import interpolate_pair
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import images, params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options

torch.set_num_threads(2)


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def tiny_state():
  rng = np.random.RandomState(1)
  state = {}
  model = film_net.create_model(Options.tiny())
  for name, value in model.state_dict().items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in ** -0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


@pytest.mark.parametrize('h,w,align,block', [(37, 53, 16, None),
                                             (64, 64, 16, (2, 2))],
                         ids=['unaligned', 'tiled2x2'])
def test_interpolator_matches_jax(tiny_state, h, w, align, block):
  rng = np.random.RandomState(2)
  x0 = rng.rand(1, h, w, 3).astype(np.float32)
  x1 = rng.rand(1, h, w, 3).astype(np.float32)
  dt = np.full((1,), 0.5, np.float32)
  want = jax_interp.Interpolator(
      params_io.to_flax_params(tiny_state), JaxOptions.tiny(), align=align,
      block_shape=block)(x0, x1, dt)
  # The state_dict, and a flax tree, are both accepted.
  for params in (tiny_state, params_io.to_flax_params(tiny_state)):
    got = Interpolator(params, Options.tiny(), align=align, block_shape=block,
                       device='cpu')(x0, x1, dt)
    assert got.shape == (1, h, w, 3) and got.dtype == np.float32
    assert _psnr(got, want) >= 50.0
    assert float(np.abs(got - want).max()) <= 1e-4


def test_interpolate_equals_untiled_call(tiny_state):
  rng = np.random.RandomState(3)
  x0 = rng.rand(2, 24, 40, 3).astype(np.float32)
  x1 = rng.rand(2, 24, 40, 3).astype(np.float32)
  dt = np.full((2,), 0.5, np.float32)
  interp = Interpolator(tiny_state, Options.tiny(), align=8, device='cpu')
  np.testing.assert_array_equal(interp.interpolate(x0, x1, dt),
                                interp(x0, x1, dt))
  got = interp.call_device(torch.from_numpy(x0), torch.from_numpy(x1),
                           torch.from_numpy(dt))
  assert isinstance(got, torch.Tensor) and tuple(got.shape) == (2, 24, 40, 3)


def test_interpolator_cuda_without_gpu_raises(tiny_state):
  if torch.cuda.is_available():
    pytest.skip('a GPU is visible; this pins the no-GPU behaviour')
  with pytest.raises(RuntimeError, match='no GPU'):
    Interpolator(tiny_state, Options.tiny(), device='cuda')


def _write_pair(tmp_path, h, w):
  rng = np.random.RandomState(4)
  paths = []
  for name in ('one.png', 'two.png'):
    path = str(tmp_path / name)
    jax_images.write_image(path, rng.rand(h, w, 3).astype(np.float32))
    paths.append(path)
  return paths


def test_cli_random_params_on_cpu(tmp_path):
  frame1, frame2 = _write_pair(tmp_path, 64, 96)
  out = str(tmp_path / 'mid.png')
  interpolate_pair.main(['--frame1', frame1, '--frame2', frame2,
                         '--params', 'random', '--output_frame', out,
                         '--device', 'cpu'])
  mid = images.read_image(out)
  assert mid.shape == (64, 96, 3)
  # The CLI is the released config with weights from seed 0.
  options = Options.film_net_released()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(0))
  want = Interpolator(model, options, device='cpu')(
      images.read_image(frame1)[None], images.read_image(frame2)[None],
      np.full((1,), 0.5, np.float32))[0]
  np.testing.assert_array_equal(images.to_uint8(mid), images.to_uint8(want))


def test_cli_cuda_without_gpu_raises(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a GPU is visible; this pins the no-GPU behaviour')
  frame1, frame2 = _write_pair(tmp_path, 8, 8)
  with pytest.raises(RuntimeError, match='no GPU'):
    interpolate_pair.main(['--frame1', frame1, '--frame2', frame2,
                           '--params', 'random', '--output_frame',
                           str(tmp_path / 'mid.png')])


def test_images_match_jax_io(tmp_path):
  rng = np.random.RandomState(5)
  image = rng.rand(9, 13, 3).astype(np.float32)
  image[0, 0] = [-0.2, 1.3, 0.5 / 255.0]
  np.testing.assert_array_equal(images.to_uint8(image),
                                jax_images.to_uint8(image))
  for ext in ('png', 'jpg'):
    ours, theirs = str(tmp_path / f'a.{ext}'), str(tmp_path / f'b.{ext}')
    images.write_image(ours, image)
    jax_images.write_image(theirs, image)
    np.testing.assert_array_equal(images.read_image(ours),
                                  jax_images.read_image(theirs))
