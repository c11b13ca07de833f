"""The port's serving surfaces on the CPU: interpolate_dir, the Predictor,
the cog adapter and load_interpolator.

A tiny-config bundle of the port (numpy-seeded weights) drives the CLI and
the Predictor. The CLI's frames must equal the library's frame tree
quantized with io.images.to_uint8, byte for byte (the same model, the same
route); the Predictor's mid frame is held against the JAX package's
Predictor on the same weights (one level of the 8-bit output: the two
forwards agree to 1e-4, which can move a value across a rounding
boundary).
"""
import ast
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from frame_interpolation_tpu.io import images as jax_images
from frame_interpolation_tpu.io import params_io as jax_params_io
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.serving import predictor as jax_predictor
from frame_interpolation_tpu_torch.cli import eval_benchmark, interpolate_dir
from frame_interpolation_tpu_torch.inference import (load_interpolator,
                                                     recursion)
from frame_interpolation_tpu_torch.io import images, params_io, video
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.serving import Predictor

torch.set_num_threads(2)

_REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, ALIGN = 30, 44, 16


@pytest.fixture(scope='module')
def tiny_state():
  """Lecun-normal kernels from a numpy seed and zero biases."""
  rng = np.random.RandomState(2)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    if value.dim() == 4:
      array = rng.randn(*value.shape) * np.prod(value.shape[1:])**-0.5
    else:
      array = np.zeros(value.shape)
    state[name] = torch.from_numpy(array.astype(np.float32))
  return state


@pytest.fixture(scope='module')
def bundle(tiny_state, tmp_path_factory):
  path = str(tmp_path_factory.mktemp('bundle'))
  params_io.save_state_bundle(path, tiny_state, Options.tiny())
  return path


def _write_clip(directory, n, seed, h=H, w=W):
  os.makedirs(directory, exist_ok=True)
  rng = np.random.RandomState(seed)
  # Names that sort wrongly as strings: frame_10 must come last.
  for index in (1, 2, 10)[:n]:
    images.write_image(os.path.join(directory, f'frame_{index}.png'),
                       rng.rand(h, w, 3).astype(np.float32))


def _written(directory):
  names = sorted(os.listdir(os.path.join(directory, 'interpolated_frames')))
  frames = [images.read_image_uint8(os.path.join(
      directory, 'interpolated_frames', name)) for name in names]
  return names, frames


# ---- interpolate_dir --------------------------------------------------------


@pytest.mark.parametrize('mode', [[], ['--streaming'],
                                  ['--streaming', '--no-cache_features'],
                                  ['--pairs_per_chunk', '1']])
def test_interpolate_dir_writes_the_library_frames(bundle, tmp_path, mode):
  clip = str(tmp_path / 'clips' / 'a')
  _write_clip(clip, 3, seed=0)
  interpolate_dir.main(['--pattern', str(tmp_path / 'clips' / '*'),
                        '--params', bundle, '--times_to_interpolate', '2',
                        '--align', str(ALIGN), '--output_video',
                        '--device', 'cpu'] + mode)
  names, frames = _written(clip)
  assert names == [f'frame_{i:03d}.png' for i in range(9)]
  interp = load_interpolator(bundle, align=ALIGN, device='cpu')
  inputs = [images.read_image(os.path.join(clip, f'frame_{i}.png'))
            for i in (1, 2, 10)]
  want = recursion.interpolate_frontier(inputs, 2, interp)
  for got, frame in zip(frames, want):
    np.testing.assert_array_equal(got, images.to_uint8(frame))
  # The mp4 needs ffmpeg; without it the frames are still written.
  assert os.path.exists(os.path.join(clip, 'interpolated.mp4')) == (
      video.have_ffmpeg())


def test_interpolate_dir_shards_the_directories(tmp_path):
  for name, seed in (('a', 1), ('b', 2), ('c', 3)):
    _write_clip(str(tmp_path / name), 2, seed, h=16, w=16)
  _write_clip(str(tmp_path / 'd'), 1, 4, h=16, w=16)  # skipped: one frame
  interpolate_dir.main(['--pattern', str(tmp_path / '*'), '--params',
                        'random', '--times_to_interpolate', '1',
                        '--num_shards', '2', '--shard_index', '1',
                        '--device', 'cpu'])
  done = sorted(p.parent.name for p in tmp_path.glob(
      '*/interpolated_frames'))
  # Sorted a, b, c, d: shard 1 of 2 is b and d, and d has one frame.
  assert done == ['b']
  names, frames = _written(str(tmp_path / 'b'))
  assert names == ['frame_000.png', 'frame_001.png', 'frame_002.png']
  assert frames[0].shape == (16, 16, 3)


def test_clis_with_cuda_raise_without_a_gpu(bundle, tmp_path):
  if torch.cuda.is_available():
    pytest.skip('a GPU is visible; this pins the no-GPU behaviour')
  _write_clip(str(tmp_path / 'a'), 2, 0)
  with pytest.raises(RuntimeError, match='no GPU'):
    interpolate_dir.main(['--pattern', str(tmp_path / '*'), '--params',
                          bundle])
  with pytest.raises(RuntimeError, match='no GPU'):
    eval_benchmark.main(['--params', bundle, '--tfrecord', 'a.tfrecord',
                         '--output_dir', str(tmp_path / 'eval')])
  with pytest.raises(RuntimeError, match='no GPU'):
    Predictor(bundle).setup()


# ---- load_interpolator --------------------------------------------------------


def test_load_interpolator_reads_the_port_bundle(bundle, tiny_state,
                                                 tmp_path):
  interp = load_interpolator(bundle, align=ALIGN, dtype_policy='bfloat16',
                             device='cpu')
  assert interp.options == Options.tiny(dtype_policy='bfloat16')
  for name, value in interp.model.state_dict().items():
    np.testing.assert_array_equal(value.numpy(), tiny_state[name].numpy())
  # The JAX package's bundle loads too, its own policy kept.
  jax_bundle = str(tmp_path / 'jax')
  jax_params_io.save_params(jax_bundle, params_io.to_flax_params(tiny_state),
                            JaxOptions.tiny(dtype_policy='bfloat16'))
  interp = load_interpolator(jax_bundle, align=ALIGN, device='cpu')
  assert interp.options == Options.tiny(dtype_policy='bfloat16')
  for name, value in interp.model.state_dict().items():
    np.testing.assert_array_equal(value.numpy(), tiny_state[name].numpy())
  # A TF SavedModel goes to io/tf_import (tests/test_torch_tf_import.py
  # loads real ones); one without its variables bundle raises.
  tf_dir = tmp_path / 'tf'
  tf_dir.mkdir()
  (tf_dir / 'saved_model.pb').write_bytes(b'')
  with pytest.raises(FileNotFoundError, match='variables.index'):
    load_interpolator(str(tf_dir), device='cpu')
  with pytest.raises(FileNotFoundError):
    load_interpolator(str(tmp_path), device='cpu')


# ---- the Predictor ------------------------------------------------------------


def _pair(tmp_path, shapes=((H, W), (H, W))):
  rng = np.random.RandomState(5)
  paths = []
  for i, (h, w) in enumerate(shapes):
    paths.append(str(tmp_path / f'in{i}.png'))
    images.write_image(paths[-1], rng.rand(h, w, 3).astype(np.float32))
  return paths


def test_predictor_mid_frame_matches_jax(bundle, tiny_state, tmp_path):
  frame1, frame2 = _pair(tmp_path, ((H, W + 6), (H + 2, W)))
  out = Predictor(bundle, align=ALIGN, device='cpu').predict(
      frame1, frame2, 1, output_dir=str(tmp_path / 'port'))
  assert out.endswith('out.png')
  got = images.read_image_uint8(out)
  assert got.shape == (H, W, 3)  # the common top-left region
  interp = load_interpolator(bundle, align=ALIGN, device='cpu')
  want = interp(images.read_image(frame1)[None, :H, :W],
                images.read_image(frame2)[None, :H, :W],
                np.full((1,), 0.5, np.float32))[0]
  np.testing.assert_array_equal(got, images.to_uint8(want))
  jax_bundle = str(tmp_path / 'jax')
  jax_params_io.save_params(jax_bundle, params_io.to_flax_params(tiny_state),
                            JaxOptions.tiny())
  jax_out = jax_predictor.Predictor(jax_bundle, align=ALIGN).predict(
      frame1, frame2, 1, output_dir=str(tmp_path / 'jax_out'))
  diff = got.astype(int) - jax_images.read_image_uint8(jax_out).astype(int)
  assert np.abs(diff).max() <= 1


def test_predictor_refuses_bad_inputs(bundle, tmp_path, monkeypatch):
  frame1, frame2 = _pair(tmp_path)
  predictor = Predictor(bundle, align=ALIGN, device='cpu')
  with pytest.raises(ValueError, match='png, jpg or jpeg'):
    predictor.predict(frame1, str(tmp_path / 'in1.gif'), 1)
  for times in (0, 9):
    with pytest.raises(ValueError, match=r'\[1, 8\]'):
      predictor.predict(frame1, frame2, times)
  monkeypatch.setattr(video, '_FFMPEG', 'ffmpeg-not-installed')
  with pytest.raises(RuntimeError, match='ffmpeg-not-installed'):
    predictor.predict(frame1, frame2, 2, output_dir=str(tmp_path / 'v'))


def test_cog_adapter_and_recipe():
  serving = _REPO / 'frame_interpolation_tpu_torch' / 'serving'
  tree = ast.parse((serving / 'cog_predict.py').read_text())
  classes = {node.name: node for node in tree.body
             if isinstance(node, ast.ClassDef)}
  methods = {f.name for f in classes['CogPredictor'].body
             if isinstance(f, ast.FunctionDef)}
  assert {'setup', 'predict'} <= methods
  source = (serving / 'cog_predict.py').read_text()
  assert 'FI_MODEL_PATH' in source and 'FI_DTYPE_POLICY' in source
  assert 'FI_WARP_IMPL' not in source
  recipe = (serving / 'cog.yaml').read_text()
  target = re.search(r'^predict:\s*"([^"]+)"', recipe, re.M).group(1)
  path, name = target.split(':')
  assert (_REPO / path).is_file() and name == 'CogPredictor'
  assert re.search(r'^\s*gpu:\s*true', recipe, re.M)
