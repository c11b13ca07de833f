"""The JAX package's weight bundle in the PyTorch port, on the CPU.

The port's msgpack reader and writer (io/msgpack_lite.py) against flax's
own serialization; the bundle (io/params_io.save_params/load_params)
against the JAX package's; `load_interpolator` on a JAX bundle against the
JAX forward on the same weights; and the CLIs that read bundles
(build_params, interpolate_pair). Weights come from a numpy seed, so no
JAX init is compiled; the file makes three JAX compiles (the template
init of JAX's load_params, the tiny forward and the released forward).
"""
import itertools
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.io import images as jax_images
from frame_interpolation_tpu.io import params_io as jax_params_io
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.cli import build_params, interpolate_pair
from frame_interpolation_tpu_torch.inference import (Interpolator,
                                                     load_interpolator)
from frame_interpolation_tpu_torch.io import images, msgpack_lite, params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import train_lib

torch.set_num_threads(2)


def _numpy_state(options, seed=0):
  """Seeded numpy weights (lecun-normal scale, small biases)."""
  rng = np.random.RandomState(seed)
  state = {}
  for name, value in film_net.create_model(options).state_dict().items():
    fan_in = int(np.prod(value.shape[1:])) if value.dim() == 4 else 1
    scale = fan_in**-0.5 if value.dim() == 4 else 0.1
    state[name] = torch.from_numpy(
        (rng.randn(*value.shape) * scale).astype(np.float32))
  return state


def _assert_trees_equal(got, want, path=''):
  """Same keys, and each leaf of the same dtype, shape and bytes."""
  if isinstance(want, dict):
    assert isinstance(got, dict) and list(got) == list(want), path
    for key in want:
      _assert_trees_equal(got[key], want[key], f'{path}/{key}')
    return
  if isinstance(got, torch.Tensor):  # bfloat16 leaves
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    return
  want = np.asarray(want)
  assert got.dtype == want.dtype and got.shape == want.shape, path
  assert got.tobytes() == want.tobytes(), path


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def tiny_bundle(tmp_path_factory):
  """A JAX bundle of the tiny config, written by the JAX package."""
  state = _numpy_state(Options.tiny())
  path = str(tmp_path_factory.mktemp('tiny_jax'))
  jax_params_io.save_params(path, params_io.to_flax_params(state),
                            JaxOptions.tiny())
  return path, state


# ---- the decoder --------------------------------------------------------------


@pytest.mark.parametrize('config', ['tiny', 'released'])
def test_decoder_reads_jax_bundles_bit_for_bit(config, tmp_path):
  options = getattr(Options, 'tiny' if config == 'tiny' else
                    'film_net_released')()
  jax_options = getattr(JaxOptions, 'tiny' if config == 'tiny' else
                        'film_net_released')()
  state = _numpy_state(options, seed=1)
  jax_params_io.save_params(str(tmp_path), params_io.to_flax_params(state),
                            jax_options)
  data = (tmp_path / params_io.PARAMS_FILE).read_bytes()
  want = flax.serialization.msgpack_restore(data)
  got = msgpack_lite.restore(data)
  _assert_trees_equal(got, want)
  # The port's writer gives back the same bytes.
  assert msgpack_lite.serialize(got) == data
  loaded, got_options = params_io.load_params(str(tmp_path))
  assert got_options == options
  for name, value in state.items():
    np.testing.assert_array_equal(loaded[name].numpy(), value.numpy())


def test_jax_load_params_reads_the_port_bundle(tiny_bundle, tmp_path):
  _, state = tiny_bundle
  path = str(tmp_path / 'port')
  params_io.save_params(path, state, Options.tiny(dtype_policy='bfloat16'))
  params, options = jax_params_io.load_params(path)
  assert options == JaxOptions.tiny(dtype_policy='bfloat16')
  _assert_trees_equal(msgpack_lite.restore(
      open(os.path.join(path, params_io.PARAMS_FILE), 'rb').read()),
                      jax.device_get(params))
  want = params_io.to_flax_params(state)
  for path_, leaf in jax.tree_util.tree_leaves_with_path(params):
    keys = [k.key for k in path_]
    node = want
    for key in keys:
      node = node[key]
    np.testing.assert_array_equal(np.asarray(leaf), node)


def test_chunked_and_bfloat16_leaves_decode(monkeypatch):
  rng = np.random.RandomState(2)
  tree = {'conv': {'kernel': rng.randn(3, 3, 4, 6).astype(np.float32),
                   'bias': np.asarray(jnp.asarray(rng.randn(37),
                                                  jnp.bfloat16))},
          'step': np.asarray(7, np.int32), 'scale': np.float32(0.5)}
  monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 40)
  data = flax.serialization.msgpack_serialize(tree)
  raw = msgpack_lite.unpackb(data)
  assert raw['conv']['kernel']['__msgpack_chunked_array__'] is True
  assert raw['conv']['bias']['__msgpack_chunked_array__'] is True
  got = msgpack_lite.restore(data)
  _assert_trees_equal(got, flax.serialization.msgpack_restore(data))
  assert got['scale'] == np.float32(0.5)
  # Written back chunked at the same size, the same bytes.
  monkeypatch.setattr(msgpack_lite, 'MAX_CHUNK_SIZE', 40)
  assert msgpack_lite.serialize(got) == data


def test_jax_options_with_tpu_fields_load(tiny_bundle, tmp_path):
  path, state = tiny_bundle
  fields = json.loads(open(os.path.join(path, 'options.json')).read())
  assert {'warp_impl', 'fold_convs', 'conv_stack', 'split_convs'} <= set(
      fields)
  loaded, options = params_io.load_params(path)
  assert options == Options.tiny()
  # split_convs is ported: a bundle's value reaches Options.
  fields['split_convs'] = 'off'
  off = tmp_path / 'off'
  off.mkdir()
  (off / 'options.json').write_text(json.dumps(fields))
  (off / params_io.PARAMS_FILE).write_bytes(
      open(os.path.join(path, params_io.PARAMS_FILE), 'rb').read())
  assert params_io.load_params(str(off))[1] == Options.tiny(split_convs='off')
  fields['pyramid_depth'] = 3
  bad = tmp_path / 'bad'
  bad.mkdir()
  (bad / 'options.json').write_text(json.dumps(fields))
  (bad / params_io.PARAMS_FILE).write_bytes(
      open(os.path.join(path, params_io.PARAMS_FILE), 'rb').read())
  with pytest.raises(ValueError, match='pyramid_depth'):
    params_io.load_params(str(bad))


@pytest.mark.parametrize('case', ['truncated', 'trailing', 'ext_code',
                                  'complex', 'int_key'])
def test_malformed_input_raises(case, tiny_bundle):
  path, _ = tiny_bundle
  data = open(os.path.join(path, params_io.PARAMS_FILE), 'rb').read()
  if case == 'truncated':
    bad = data[:len(data) // 2]
  elif case == 'trailing':
    bad = data + b'\x00'
  elif case == 'ext_code':
    bad = b'\x81\xa1a\xd4\x05\x00'  # {'a': fixext1 of code 5}
  elif case == 'complex':
    bad = flax.serialization.msgpack_serialize({'z': 1 + 2j})
  else:
    bad = b'\x81\x01\xc0'  # {1: None}
  with pytest.raises(msgpack_lite.MsgpackError):
    msgpack_lite.restore(bad)


# ---- the forwards ---------------------------------------------------------------


@pytest.mark.parametrize('config', ['tiny', 'released'])
def test_jax_bundle_serves_jax_forward(config, tiny_bundle, tmp_path):
  if config == 'tiny':
    path, state = tiny_bundle
    jax_options, h, w, align = JaxOptions.tiny(), 32, 48, 16
  else:
    state = _numpy_state(Options.film_net_released(), seed=3)
    path = str(tmp_path / 'released')
    jax_options, h, w, align = JaxOptions.film_net_released(), 64, 64, 64
    jax_params_io.save_params(path, params_io.to_flax_params(state),
                              jax_options)
  rng = np.random.RandomState(4)
  x0, x1 = rng.rand(2, 1, h, w, 3).astype(np.float32)
  t = np.full((1, 1), 0.5, np.float32)
  interp = load_interpolator(path, align=align, device='cpu')
  got = interp(x0, x1, t[:, 0])
  model = jax_film_net.create_model(jax_options)
  want = jax.jit(model.apply)({'params': params_io.to_flax_params(state)},
                              x0, x1, t)['image']
  assert got.shape == (1, h, w, 3)
  assert _psnr(got, want) >= 50.0


# ---- the CLIs ---------------------------------------------------------------------


def test_build_params_converts_a_jax_bundle(tiny_bundle, tmp_path):
  path, state = tiny_bundle
  out = str(tmp_path / 'port')
  assert build_params.main(['--jax_bundle', path, '--output', out]) == out
  loaded, options = params_io.load_state_bundle(out)
  assert options == Options.tiny()
  for name, value in state.items():
    np.testing.assert_array_equal(loaded[name].numpy(), value.numpy())
  with pytest.raises(SystemExit):  # --output is required
    build_params.main(['--jax_bundle', path])
  with pytest.raises(FileNotFoundError):
    build_params.main(['--jax_bundle', str(tmp_path), '--output', out])


def test_build_params_exports_the_newest_checkpoint(tmp_path):
  options = Options.film_net_released()
  run = tmp_path / 'runs' / 'run0'
  ckpt = train_lib.CheckpointManager(str(run / 'train'))
  states = {}
  for step in (3, 12):  # 12 is the newest, though '12' < '3' as text
    states[step] = _numpy_state(options, seed=step)
    model = film_net.create_model(options)
    model.load_state_dict(states[step])
    train_state = train_lib.create_train_state(model,
                                               train_lib.TrainingOptions())
    train_state.step = step
    ckpt.save(train_state)
  # No options.json beside the checkpoints: the released configuration.
  out = build_params.main(['--base_folder', str(tmp_path / 'runs'),
                           '--label', 'run0'])
  assert out == str(run / 'saved_model')
  loaded, got_options = params_io.load_state_bundle(out)
  assert got_options == options
  for name, value in states[12].items():
    np.testing.assert_array_equal(loaded[name].numpy(), value.numpy())
  with pytest.raises(FileNotFoundError):
    build_params.main(['--base_folder', str(tmp_path), '--label', 'none'])
  with pytest.raises(SystemExit):
    build_params.main([])


def test_build_params_reads_the_options_the_trainer_wrote(tmp_path):
  # A run at widths other than the released ones (as a gin file may set
  # them) converts with the options that train_lib.train kept.
  options = Options.tiny()
  rng = np.random.RandomState(2)
  batch = {k: rng.rand(1, 16, 16, 3).astype(np.float32)
           for k in ('x0', 'x1', 'y')}
  batch['time'] = np.full((1, 1), 0.5, np.float32)
  state = train_lib.train(
      film_net.create_model(options), options,
      losses.training_losses(['l1']), itertools.repeat(batch),
      train_lib.TrainingOptions(num_steps=2, save_interval=2),
      str(tmp_path / 'runs' / 'tiny'), device='cpu', log_fn=lambda _: None)
  out = build_params.main(['--base_folder', str(tmp_path / 'runs'),
                           '--label', 'tiny', '--output',
                           str(tmp_path / 'built')])
  loaded, got_options = params_io.load_state_bundle(out)
  assert got_options == options
  for name, value in state.model.state_dict().items():
    torch.testing.assert_close(loaded[name], value, rtol=0, atol=0)


def _write_pair(tmp_path, h, w):
  rng = np.random.RandomState(5)
  paths = []
  for name in ('one.png', 'two.png'):
    paths.append(str(tmp_path / name))
    jax_images.write_image(paths[-1], rng.rand(h, w, 3).astype(np.float32))
  return paths


@pytest.mark.parametrize('extra', [[], ['--time', '0.5'],
                                   ['--dtype_policy', 'float32']],
                         ids=['bundle', 'time', 'dtype_policy'])
def test_interpolate_pair_reads_a_jax_bundle(extra, tiny_bundle, tmp_path):
  _, state = tiny_bundle
  path = str(tmp_path / 'bf16')
  params_io.save_params(path, state, Options.tiny(dtype_policy='bfloat16'))
  frame1, frame2 = _write_pair(tmp_path, 30, 44)
  out = str(tmp_path / 'mid.png')
  interpolate_pair.main(['--frame1', frame1, '--frame2', frame2, '--params',
                         path, '--output_frame', out, '--align', '16',
                         '--device', 'cpu'] + extra)
  # The bundle keeps its bf16 policy unless the flag overrides it.
  policy = 'float32' if '--dtype_policy' in extra else 'bfloat16'
  want = Interpolator(state, Options.tiny(dtype_policy=policy), align=16,
                      device='cpu')(
      images.read_image(frame1)[None], images.read_image(frame2)[None],
      np.full((1,), 0.5, np.float32))[0]
  np.testing.assert_array_equal(images.read_image_uint8(out),
                                images.to_uint8(want))


def test_interpolate_pair_refuses_a_time_off_the_midpoint(tiny_bundle,
                                                          tmp_path):
  # film_net predicts the midpoint only: another time would be ignored.
  path, _ = tiny_bundle
  frame1, frame2 = _write_pair(tmp_path, 30, 44)
  out = str(tmp_path / 'mid.png')
  with pytest.raises(SystemExit):
    interpolate_pair.main(['--frame1', frame1, '--frame2', frame2,
                           '--params', path, '--output_frame', out,
                           '--time', '0.25', '--device', 'cpu'])
  assert not os.path.exists(out)
