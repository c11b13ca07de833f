"""The split-concat convs (Options.split_convs) of the port, on the CPU.

A conv whose input is a channel concat runs as one conv per piece with the
weight's slice of input channels, the partial outputs summed and the bias
added once (models/layers.Conv on a list). Held here: the layer on pieces
against the layer on their concat; the tiny FilmNet split against
unsplit, forward and train-step gradients; the port's split form against
the JAX FilmNet's (`split_convs='on', fold_convs='off'`) in f32 and under
the bf16 policy; the row-sharded forward with split convs against one
device, and its halo exchanges against the concat form's; and a JAX
bundle's `split_convs` reaching the port's Options. Two JAX compiles.
"""
import jax
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.io import params_io as jax_params_io
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch import losses, parallel
from frame_interpolation_tpu_torch.inference import (Interpolator,
                                                     load_interpolator)
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net, layers
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import shard_map

torch.set_num_threads(2)


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


def _model(split, dtype_policy='float32', state=None):
  options = Options.tiny(split_convs=split, dtype_policy=dtype_policy)
  model = film_net.create_model(options)
  model.load_state_dict(state if state is not None else
                        _numpy_state(Options.tiny()))
  return model


def _inputs(h=32, w=48, seed=0):
  rng = np.random.RandomState(seed)
  return (rng.rand(2, h, w, 3).astype(np.float32),
          rng.rand(2, h, w, 3).astype(np.float32),
          np.full((2, 1), 0.5, np.float32))


def _forward(model, x0, x1, t):
  with torch.inference_mode():
    return model(torch.from_numpy(x0), torch.from_numpy(x1),
                 torch.from_numpy(t))


# ---- the layer -----------------------------------------------------------------


@pytest.mark.parametrize('k', [1, 2, 3])
@pytest.mark.parametrize('sizes', [(5, 3), (7, 2, 4)])
def test_conv_on_pieces_equals_conv_on_concat(k, sizes):
  rng = np.random.RandomState(k)
  conv = layers.Conv(sum(sizes), 6, k, torch.float32)
  with torch.no_grad():
    conv.weight.copy_(torch.from_numpy(rng.randn(6, sum(sizes), k, k)))
    conv.bias.copy_(torch.from_numpy(rng.randn(6)))
  pieces = [torch.from_numpy(rng.rand(2, 9, 11, c).astype(np.float32))
            for c in sizes]
  with torch.no_grad():
    want = conv(torch.cat(pieces, dim=-1))
    got = conv(pieces)
  assert got.shape == want.shape == (2, 9, 11, 6)
  scale = float(want.abs().max())
  assert float((got - want).abs().max()) <= 1e-6 * scale


def test_conv_on_pieces_rounds_as_jax_under_bf16():
  # Each partial output rounds to bf16, then their sum, then the bias is
  # added: JAX's order (ops/folded_conv.FoldableConv's split branch).
  rng = np.random.RandomState(3)
  conv = layers.Conv(6, 4, 3, torch.bfloat16)
  with torch.no_grad():
    conv.weight.copy_(torch.from_numpy(rng.randn(4, 6, 3, 3)))
    conv.bias.copy_(torch.from_numpy(rng.randn(4)))
  a = torch.from_numpy(rng.rand(1, 5, 7, 4).astype(np.float32))
  b = torch.from_numpy(rng.rand(1, 5, 7, 2).astype(np.float32))
  with torch.no_grad():
    got = conv([a, b])
    w = conv.weight.to(torch.bfloat16)
    part_a = conv._conv(a, w[:, :4], None)
    part_b = conv._conv(b, w[:, 4:], None)
    want = (part_a + part_b) + conv.bias.to(torch.bfloat16)
  assert got.dtype == torch.bfloat16
  assert torch.equal(got, want)


def test_conv_on_pieces_checks_the_channels():
  conv = layers.Conv(8, 4, 3, torch.float32)
  with pytest.raises(ValueError, match='input channels'):
    conv([torch.zeros(1, 4, 4, 5), torch.zeros(1, 4, 4, 2)])


def test_should_split_by_mode_and_device():
  # Every mode but 'off' splits, whatever the device.
  assert layers.should_split('on')
  assert layers.should_split('auto')
  assert not layers.should_split('off')
  for device in ('cpu', 'meta'):
    pieces = [torch.zeros(1, 2, 2, 3, device=device),
              torch.zeros(1, 2, 2, 1, device=device)]
    assert layers.conv_input(pieces, 'on') is pieces
    assert layers.conv_input(pieces, 'auto') is pieces
    assert layers.conv_input(pieces, 'off').shape == (1, 2, 2, 4)


# ---- the model -------------------------------------------------------------------


def test_film_net_split_equals_concat(monkeypatch):
  # The two forms run different convs: count the concats the model builds
  # at the two call sites.
  cats = []
  real_cat = torch.cat

  def counted_cat(tensors, dim=0):
    if len(tensors) == 2 and dim == -1:
      cats.append(tensors[0].shape[-1] + tensors[1].shape[-1])
    return real_cat(tensors, dim=dim)

  x0, x1, t = _inputs()
  monkeypatch.setattr(torch, 'cat', counted_cat)
  on = _forward(_model('on'), x0, x1, t)
  split_cats = len(cats)
  off = _forward(_model('off'), x0, x1, t)
  monkeypatch.undo()
  options = Options.tiny()
  # 2 directions x pyramid_levels flow predictors + the fusion's levels - 1.
  sites = 2 * options.pyramid_levels + options.fusion_pyramid_levels - 1
  assert len(cats) - split_cats - split_cats == sites
  assert set(on) == set(off)
  for key in ('image', 'x0_warped', 'x1_warped'):
    scale = float(off[key].abs().max())
    assert float((on[key] - off[key]).abs().max()) <= 1e-5 * scale, key
  for g, w in zip(on['forward_flow_pyramid'], off['forward_flow_pyramid']):
    assert float((g - w).abs().max()) <= 1e-5


@pytest.mark.parametrize('dtype_policy', ['float32', 'bfloat16'])
def test_split_form_matches_jax_split_form(dtype_policy):
  state = _numpy_state(Options.tiny())
  x0, x1, t = _inputs(seed=1)
  jax_model = jax_film_net.create_model(JaxOptions.tiny(
      split_convs='on', fold_convs='off', dtype_policy=dtype_policy))
  want = jax.jit(jax_model.apply)({'params': params_io.to_flax_params(state)},
                                  x0, x1, t)
  got = _forward(_model('on', dtype_policy, state), x0, x1, t)
  image = got['image'].numpy()
  if dtype_policy == 'float32':
    assert float(np.abs(image - np.asarray(want['image'])).max()) <= 1e-5
    for g, w in zip(got['forward_flow_pyramid'],
                    want['forward_flow_pyramid']):
      assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-4
  else:
    assert _psnr(image, want['image']) >= 50.0


def _loss_and_grads(model, x0, x1, t):
  batch = {'x0': torch.from_numpy(x0), 'x1': torch.from_numpy(x1),
           'y': torch.from_numpy(0.5 * (x0 + x1)), 'time': torch.from_numpy(t)}
  model.zero_grad(set_to_none=True)
  loss = losses.l1_loss(batch, model(batch['x0'], batch['x1'], batch['time']))
  loss.backward()
  return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_train_step_gradients_split_equal_concat():
  x0, x1, t = _inputs(seed=2)
  loss_on, grads_on = _loss_and_grads(_model('on'), x0, x1, t)
  loss_off, grads_off = _loss_and_grads(_model('off'), x0, x1, t)
  assert abs(loss_on - loss_off) <= 1e-6 * abs(loss_off)
  assert set(grads_on) == set(grads_off)
  for name, g in grads_on.items():
    scale = float(grads_off[name].abs().max())
    assert scale > 0, name
    assert float((g - grads_off[name]).abs().max()) <= 1e-4 * scale, name


# ---- row sharding ------------------------------------------------------------------


def test_row_sharded_split_form_matches_one_device(monkeypatch):
  state = _numpy_state(Options.tiny(), seed=3)
  rng = np.random.RandomState(4)
  x0, x1 = (rng.rand(1, 64, 64, 3).astype(np.float32) for _ in range(2))
  dt = np.full((1,), 0.5, np.float32)
  want = Interpolator(state, Options.tiny(split_convs='on'), align=16,
                      device='cpu')(x0, x1, dt)
  exchanges = {}
  real_exchange = shard_map.Collective.exchange

  def counted(self, index, value):
    exchanges[self] = exchanges.get(self, 0) + 1
    return real_exchange(self, index, value)

  monkeypatch.setattr(shard_map.Collective, 'exchange', counted)
  got = {}
  for split in ('on', 'off'):
    exchanges.clear()
    got[split] = parallel.SpatialShardedInterpolator(
        state, Options.tiny(split_convs=split), parallel.Mesh(['cpu'] * 2),
        align=16)(x0, x1, dt)
    got[split + '_exchanges'] = sum(exchanges.values())
  assert got['on'].shape == want.shape
  assert float(np.abs(got['on'] - want).max()) <= 1e-5
  assert float(np.abs(got['off'] - want).max()) <= 1e-5
  # A split conv's pieces share one halo exchange: the count is the
  # concat form's.
  assert got['on_exchanges'] == got['off_exchanges'] > 0


# ---- bundles --------------------------------------------------------------------------


def test_jax_bundle_split_convs_reaches_the_port(tmp_path):
  state = _numpy_state(Options.tiny())
  jax_params_io.save_params(str(tmp_path), params_io.to_flax_params(state),
                            JaxOptions.tiny(split_convs='off'))
  interp = load_interpolator(str(tmp_path), align=16, device='cpu')
  assert interp.options.split_convs == 'off'
  assert interp.model.fusion.split_convs == 'off'
  port = tmp_path / 'port'
  params_io.save_state_bundle(str(port), state, interp.options)
  assert params_io.load_state_bundle(str(port))[1].split_convs == 'off'
