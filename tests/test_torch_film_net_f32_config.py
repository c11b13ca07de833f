"""The benchmark's film_net-released-f32 configuration on the CPU: its model
block builds the port's released film_net in f32, and that forward, served
through `Interpolator` as the pair cell serves it, matches the plain
reference (film_bench/reference/film_net.py) on seeded weights at a small
frame. Its result crosses to the host into a new array whose pages are
touched first; marked `card` (run with `--noconftest` on the card), a
result of the card lands there, a new array each call."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from film_bench import weights
from film_bench.drivers import common
from film_bench.reference import film_net as ref
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.inference import interpolator as interp_lib
from frame_interpolation_tpu_torch.models.film_net import FilmNet
from frame_interpolation_tpu_torch.options import Options

CONFIGS = Path(__file__).resolve().parent.parent / 'film_bench' / 'configs'
# Port against reference, both f32 on the CPU, on [0, 1] images: the same
# arithmetic in another order (NHWC and split convs against NCHW concats)
# reads about 1.3e-6 here; the reference with its convs' operands rounded
# to bf16 reads about 3.7e-3.
MAX_ABS = 1e-4


def _config(name):
  return json.loads((CONFIGS / f'{name}.json').read_text())


@pytest.fixture(scope='module')
def released_f32():
  config = _config('film_net-released-f32')
  options = Options(**common.options_dict(config))
  shapes = ref.parameter_shapes(dataclasses.asdict(options))
  params = weights.film_net(shapes, 2**31 + 11, 'cpu')
  generator = torch.Generator().manual_seed(11)
  for k in params:  # biases too, so that they are tested
    if k.endswith('bias'):
      params[k] = 0.05 * torch.randn(params[k].shape, generator=generator)
  model = FilmNet(options)
  model.load_state_dict(params)
  return config, options, model, params


def test_the_block_is_the_released_model_in_f32(released_f32):
  config, options, model, _ = released_f32
  bf16 = _config('film_net-released-bf16')
  assert options.dtype_policy == 'float32'
  assert options == dataclasses.replace(Options.film_net_released(),
                                        dtype_policy='float32')
  assert {k: v for k, v in config['model'].items() if k != 'dtype_policy'} == (
      {k: v for k, v in bf16['model'].items() if k != 'dtype_policy'})
  assert sum(p.numel() for p in model.parameters()) == config['parameters']
  assert all(p.dtype == torch.float32 for p in model.parameters())
  assert config['reduced'] == [] and config['align'] == 64
  assert (config['precision'], config['mfu_peak']) == ('float32_tf32', 'tf32')
  assert config['cudnn_allow_tf32'] and not config['matmul_allow_tf32']
  assert config['program_control'] == {'model': {'dtype_policy': 'bfloat16'}}


def test_the_f32_forward_matches_the_reference(released_f32):
  config, options, model, params = released_f32
  align = int(config['align'])
  frames = np.random.RandomState(4).randint(0, 256, (2, 1, 50, 100, 3),
                                            np.uint8)
  got = Interpolator(model, options, align=align, device='cpu')(
      frames[0], frames[1], np.full((1,), 0.5, np.float32))
  assert got.dtype == np.float32 and got.shape == (1, 50, 100, 3)
  x0, x1 = (common.unit_nchw(f, 'cpu') for f in frames)
  with torch.no_grad():
    want = ref.interpolate(params, dataclasses.asdict(options), x0, x1,
                           align).permute(0, 2, 3, 1).numpy()
  assert np.abs(got - want).max() <= MAX_ABS
  assert np.abs(want).max() > 0.1  # the model computes something


@pytest.mark.parametrize('dtype,shape', [(torch.float32, (1, 50, 100, 3)),
                                         (torch.uint8, (3, 7, 5, 3)),
                                         (torch.float32, (0, 4, 4, 3))])
def test_results_cross_into_new_touched_arrays(dtype, shape):
  t = torch.zeros(shape, dtype=dtype)
  first, second = (interp_lib.touched_empty(t) for _ in range(2))
  for host in (first, second):
    assert host.shape == shape and host.dtype == t.numpy().dtype
    assert host.flags.writeable and host.flags.c_contiguous
  assert not np.shares_memory(first, second)


@pytest.mark.card
def test_a_card_result_lands_in_a_new_array():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card with --noconftest)')
  options = Options.film_net_released(dtype_policy='float32')
  model = FilmNet(options)
  interp = Interpolator(model, options, align=64, device='cuda')
  frames = np.random.RandomState(5).randint(0, 256, (2, 1, 100, 150, 3),
                                            np.uint8)
  dt = np.full((1,), 0.5, np.float32)
  first = interp(frames[0], frames[1], dt)
  second = interp(frames[0], frames[1], dt)
  want = interp.call_device(interp.to_device(frames[0]),
                            interp.to_device(frames[1]),
                            interp.to_device(dt)).cpu().numpy()
  assert first.dtype == np.float32 and first.shape == (1, 100, 150, 3)
  assert not np.shares_memory(first, second)
  assert np.array_equal(first, want) and np.array_equal(second, want)
