"""The PyTorch port's FilmNet against the JAX package's, on the CPU.

Weights made with numpy from a seed go into the port's FilmNet and, through
the weights bridge (io/params_io.to_flax_params), into the JAX FilmNet; the
same numpy inputs go through both forwards. On CPU tensors the port runs
the plain versions of its kernels, so this pins the whole slice's
arithmetic.
"""
import jax
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.models.layers import Conv
from frame_interpolation_tpu_torch.options import Options

torch.set_num_threads(2)

_FLOW_KEYS = ('forward_residual_flow_pyramid',
              'backward_residual_flow_pyramid', 'forward_flow_pyramid',
              'backward_flow_pyramid')


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def _numpy_state(options, seed=0):
  """Seeded numpy weights (lecun-normal scale) in the port's state_dict."""
  rng = np.random.RandomState(seed)
  state = {}
  for name, value in film_net.create_model(options).state_dict().items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in ** -0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


def _both_forwards(options_kwargs, h=32, w=48):
  state = _numpy_state(Options.tiny(**options_kwargs))
  model = film_net.create_model(Options.tiny(**options_kwargs))
  model.load_state_dict(state)
  params = params_io.to_flax_params(state)
  jax_model = jax_film_net.create_model(JaxOptions.tiny(**options_kwargs))
  rng = np.random.RandomState(0)
  x0 = rng.rand(2, h, w, 3).astype(np.float32)
  x1 = rng.rand(2, h, w, 3).astype(np.float32)
  t = np.full((2, 1), 0.5, np.float32)
  want = jax.jit(jax_model.apply)({'params': params}, x0, x1, t)
  with torch.inference_mode():
    got = model(torch.from_numpy(x0), torch.from_numpy(x1),
                torch.from_numpy(t))
  return got, want


@pytest.mark.parametrize('filters', [4, 64], ids=['tiny', 'tiny_c64'])
def test_forward_f32_matches_jax(filters):
  # filters=64 gives the extractor's conv stacks the channel counts the
  # CUDA kernel takes, as the released config does; on the CPU both
  # widths run ops/conv_stack's plain version at the same sites.
  got, want = _both_forwards({'filters': filters})
  assert set(got) == set(want)
  assert got['image'].shape == want['image'].shape == (2, 32, 48, 3)
  assert _psnr(got['image'].numpy(), want['image']) >= 50.0
  for key in ('x0_warped', 'x1_warped'):
    assert _psnr(got[key].numpy(), want[key]) >= 50.0
  for key in _FLOW_KEYS:
    assert len(got[key]) == len(want[key])
    for g, w in zip(got[key], want[key]):
      assert g.dtype == torch.float32
      assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-4, key


@pytest.mark.parametrize('filters', [4, 64], ids=['tiny', 'tiny_c64'])
def test_forward_bf16_policy_matches_jax(filters):
  got, want = _both_forwards({'dtype_policy': 'bfloat16',
                              'filters': filters})
  assert got['image'].dtype == torch.float32
  # Measured 51.7 dB (tiny) and 59.0 dB (tiny_c64) on this input (torch
  # 2.13 CPU, jax 0.9): bf16 rounds at other places in the two frameworks
  # (the port's warp blends in f32, JAX's in bf16; the port's conv stack
  # adds its bias in f32 and rounds once).
  assert _psnr(got['image'].numpy(), want['image']) >= 30.0


def test_bridge_matches_released_tree():
  # jax.eval_shape: the released parameter tree without computing it.
  jax_model = jax_film_net.create_model(JaxOptions.film_net_released())
  shapes = jax.eval_shape(
      lambda: jax_film_net.init_params(jax_model, jax.random.PRNGKey(0)))
  leaves = jax.tree_util.tree_leaves(shapes)
  assert len(leaves) == 82
  assert sum(int(np.prod(l.shape)) for l in leaves) == 34_436_667

  tree = jax.tree_util.tree_map(
      lambda s: np.zeros(s.shape, np.float32), shapes)
  state = params_io.from_flax_params(tree)
  model_state = film_net.create_model(
      Options.film_net_released()).state_dict()
  assert {k: tuple(v.shape) for k, v in state.items()} == {
      k: tuple(v.shape) for k, v in model_state.items()}
  assert sum(v.numel() for v in model_state.values()) == 34_436_667


def test_bridge_round_trip_is_exact():
  jax_model = jax_film_net.create_model(JaxOptions.tiny())
  shapes = jax.eval_shape(
      lambda: jax_film_net.init_params(jax_model, jax.random.PRNGKey(0)))
  rng = np.random.RandomState(3)
  params = jax.tree_util.tree_map(
      lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
  state = params_io.from_flax_params(params)
  flat = dict(jax.tree_util.tree_leaves_with_path(params))
  kernel = flat[tuple(jax.tree_util.DictKey(k) for k in (
      'fusion', 'conv_0_0', 'kernel'))]
  np.testing.assert_array_equal(
      state['fusion.conv_0_0.weight'].numpy(), kernel.transpose(3, 2, 0, 1))
  back = dict(jax.tree_util.tree_leaves_with_path(
      params_io.to_flax_params(state)))
  assert back.keys() == flat.keys()
  for path, value in flat.items():
    np.testing.assert_array_equal(back[path], value)


def test_init_params_seeded_lecun_normal():
  options = Options.tiny(filters=16)
  a = film_net.init_params(film_net.create_model(options),
                           torch.Generator().manual_seed(0))
  b = film_net.init_params(film_net.create_model(options),
                           torch.Generator().manual_seed(0))
  for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
    torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
  conv = a.feat_net.sub_extractor.cfeat_conv_3  # 32 -> 32, 3x3
  assert isinstance(conv, Conv)
  assert not conv.bias.any()
  fan_in = 32 * 9
  std = float(conv.weight.detach().std())
  # lecun_normal: unit variance over fan_in, truncated at 2 sigma.
  assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
  bound = 2 * fan_in ** -0.5 / .8796
  assert float(conv.weight.detach().abs().max()) <= bound + 1e-6
