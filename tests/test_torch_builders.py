"""The port's dataset builders and native CRC against the JAX package's.

The builders (data/builders/triplets.py and the four cli/create_*_tfrecord
entry points) on synthetic image trees laid out as each benchmark lays
them out, against the JAX package's builders on the same trees: the
resampling exactly, each Example's decoded features, each shard's records
in order. The native CRC (native/, a C library built with the host's C
compiler at first use) against the port's Python loop and the JAX
package's CRC, its TFRecord scan against files both writers wrote, and
the Python fallback where no library builds. No JAX compile.
"""
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from frame_interpolation_tpu.data import example_proto as jax_example_proto
from frame_interpolation_tpu.data import tfrecord as jax_tfrecord
from frame_interpolation_tpu.data.builders import triplets as jax_triplets
from frame_interpolation_tpu_torch import native
from frame_interpolation_tpu_torch.cli import (create_middlebury_tfrecord,
                                               create_ucf101_tfrecord,
                                               create_vimeo90K_tfrecord,
                                               create_xiph_tfrecord)
from frame_interpolation_tpu_torch.data import example_proto, tfrecord
from frame_interpolation_tpu_torch.data.builders import triplets

_REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def native_lib():
  """The native library; skips where the host has no C compiler."""
  if shutil.which(os.environ.get('CC', 'cc')) is None:
    pytest.skip('no C compiler (cc) on PATH to build the native CRC')
  return native.library()


def _write_png(path, seed, h=24, w=32):
  from PIL import Image
  pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
  rng = np.random.RandomState(seed)
  Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
      path)


def _records(spec):
  return [example_proto.decode_example(r)
          for r in tfrecord.read_sharded(spec, validate=True)]


# ---- resampling ------------------------------------------------------------------


@pytest.mark.parametrize('shape,out', [((12, 18, 3), (6, 9)),
                                       ((17, 23, 3), (5, 7)),
                                       ((9, 8), (4, 3))])
def test_resize_local_mean_matches_jax(shape, out):
  image = np.random.RandomState(0).rand(*shape)
  np.testing.assert_array_equal(triplets.resize_local_mean(image, *out),
                                jax_triplets.resize_local_mean(image, *out))


def test_resample_image_matches_jax():
  image = np.random.RandomState(1).randint(0, 256, (30, 44, 3)).astype(
      np.uint8)
  got = triplets.resample_image(image, 22, 15)
  assert got.dtype == np.uint8 and got.shape == (15, 22, 3)
  np.testing.assert_array_equal(got,
                                jax_triplets.resample_image(image, 22, 15))


# ---- one Example -------------------------------------------------------------------


@pytest.mark.parametrize('case', ['plain', 'cropped', 'scaled',
                                  'cropped_scaled'])
def test_triplet_example_matches_jax(case, tmp_path):
  pytest.importorskip('PIL')
  paths = {}
  for i, key in enumerate(('frame_0', 'frame_1', 'frame_2')):
    paths[key] = str(tmp_path / 'clip' / f'{key}.png')
    _write_png(paths[key], seed=i, h=28, w=36)
  kwargs = {'plain': {}, 'cropped': {'center_crop_factor': 2},
            'scaled': {'scale_factor': 2},
            'cropped_scaled': {'center_crop_factor': 2, 'scale_factor': 2}
            }[case]
  ours = triplets.generate_image_triplet_example(paths, **kwargs)
  theirs = jax_triplets.generate_image_triplet_example(paths, **kwargs)
  assert ours == theirs
  features = example_proto.decode_example(ours)
  assert features == jax_example_proto.decode_example(theirs)
  assert features['path'] == [str(tmp_path / 'clip').encode()]
  want_hw = {'plain': (28, 36), 'cropped': (14, 18), 'scaled': (14, 18),
             'cropped_scaled': (7, 9)}[case]
  assert (features['frame_1/height'][0],
          features['frame_1/width'][0]) == want_hw
  if case == 'plain':  # the file's own bytes
    assert features['frame_0/encoded'] == [
        pathlib.Path(paths['frame_0']).read_bytes()]


def test_unreadable_or_missing_image_is_skipped(tmp_path, caplog):
  pytest.importorskip('PIL')
  paths = {key: str(tmp_path / f'{key}.png')
           for key in ('frame_0', 'frame_1', 'frame_2')}
  for i, key in enumerate(('frame_0', 'frame_1')):
    _write_png(paths[key], seed=i)
  assert triplets.generate_image_triplet_example(paths) is None  # missing
  pathlib.Path(paths['frame_2']).write_bytes(b'not a png')
  assert triplets.generate_image_triplet_example(paths) is None
  assert jax_triplets.generate_image_triplet_example(paths) is None
  assert 'Cannot read image file' in caplog.text
  with pytest.raises(ValueError, match='exactly 3'):
    triplets.generate_image_triplet_example({'frame_0': paths['frame_0']})


def test_run_pipeline_shards_round_robin_and_skips(tmp_path):
  pytest.importorskip('PIL')
  triplet_dicts = []
  for t in range(5):
    d = {key: str(tmp_path / f'clip{t}' / f'{key}.png')
         for key in ('frame_0', 'frame_1', 'frame_2')}
    for i, path in enumerate(d.values()):
      _write_png(path, seed=10 * t + i, h=8, w=8)
    triplet_dicts.append(d)
  pathlib.Path(triplet_dicts[1]['frame_2']).write_bytes(b'broken')
  out = str(tmp_path / 'out' / 'set.tfrecord')
  assert triplets.run_pipeline(triplet_dicts, out, 2, num_workers=3) == 4
  paths = [r['path'][0].decode()
           for r in _records(out + '@2')]
  # Shard 0 holds written examples 0 and 2, shard 1 examples 1 and 3.
  assert paths == [str(tmp_path / f'clip{t}') for t in (0, 3, 2, 4)]


# ---- the four CLIs ------------------------------------------------------------------


def _tree(kind, root):
  """A small tree laid out as the benchmark's; returns (port argv, JAX
  argv) without the output flag."""
  if kind == 'middlebury':
    for c, clip in enumerate(('Beanbags', 'Dimetrodon', 'RubberWhale')):
      _write_png(f'{root}/other-data/{clip}/frame10.png', 3 * c)
      _write_png(f'{root}/other-data/{clip}/frame11.png', 3 * c + 1)
      _write_png(f'{root}/other-gt-interp/{clip}/frame10i11.png', 3 * c + 2)
    args = ['--input_dir', root, '--num_shards', '2']
  elif kind == 'ucf101':
    for c in range(3):
      for i, name in enumerate(('frame_00.png', 'frame_01_gt.png',
                                'frame_02.png')):
        _write_png(f'{root}/{c + 1}/{name}', 3 * c + i)
    args = ['--input_dir', root]
  elif kind == 'vimeo':
    names = ['00001/0001', '00001/0002', '00002/0001']
    for c, name in enumerate(names):
      for i in range(3):
        _write_png(f'{root}/sequences/{name}/im{i + 1}.png', 3 * c + i)
    with open(f'{root}/tri_testlist.txt', 'w') as f:
      f.write('\n'.join(names) + '\n\n')
    args = ['--input_dir', f'{root}/sequences',
            '--input_triplet_list_filepath', f'{root}/tri_testlist.txt',
            '--num_shards', '3']
  else:
    for i in range(12):
      _write_png(f'{root}/frames/{i:03d}.png', i, h=32, w=40)
    args = ['--input_dir', f'{root}/frames', '--num_clips', '2',
            '--num_frames', '6']
  return args


_CLIS = {'middlebury': create_middlebury_tfrecord,
         'ucf101': create_ucf101_tfrecord,
         'vimeo': create_vimeo90K_tfrecord,
         'xiph': create_xiph_tfrecord}
_JAX_CLIS = {'middlebury': 'create_middlebury_tfrecord',
             'ucf101': 'create_ucf101_tfrecord',
             'vimeo': 'create_vimeo90K_tfrecord',
             'xiph': 'create_xiph_tfrecord'}


@pytest.mark.parametrize('kind', list(_CLIS))
def test_builder_cli_matches_jax(kind, tmp_path):
  pytest.importorskip('PIL')
  root = str(tmp_path / 'data')
  args = _tree(kind, root)
  ours = str(tmp_path / 'ours' / f'{kind}.tfrecord')
  theirs = str(tmp_path / 'theirs' / f'{kind}.tfrecord')
  written = _CLIS[kind].main(args + ['--output_tfrecord_filepath', ours])
  proc = subprocess.run(
      [sys.executable, '-m', f'frame_interpolation_tpu.cli.{_JAX_CLIS[kind]}',
       *args, '--output_tfrecord_filepath', theirs],
      capture_output=True, text=True, check=False, timeout=300, cwd=_REPO,
      env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
  assert proc.returncode == 0, proc.stderr
  shards = int(args[args.index('--num_shards') + 1]) if (
      '--num_shards' in args) else 2
  assert written == {'middlebury': 3, 'ucf101': 3, 'vimeo': 3,
                     'xiph': 4}[kind]
  for i in range(shards):
    name = f'-{i:05d}-of-{shards:05d}'
    got = [example_proto.decode_example(r)
           for r in tfrecord.read_records(ours + name)]
    want = [jax_example_proto.decode_example(r)
            for r in jax_tfrecord.read_records(theirs + name)]
    assert got == want, i
  if kind == 'xiph':  # 64x80 -> 16x20 at scale 2: Xiph-2K's resampling
    record = _records(f'{ours}@{shards}')[0]
    assert (record['frame_0/height'], record['frame_0/width']) == ([16],
                                                                   [20])


# ---- the native CRC -------------------------------------------------------------------


def _payloads():
  rng = np.random.RandomState(5)
  return ([b''] + [rng.bytes(n) for n in range(1, 18)] +
          [rng.bytes(1 << 20)])


def test_native_crc_matches_python_and_jax(native_lib):
  for data in _payloads():
    want = tfrecord.python_crc32c(data)
    assert native.crc32c(data) == want == jax_tfrecord.crc32c(data), len(data)
    assert native.masked_crc32c(data) == tfrecord.python_masked_crc32c(data)
    assert native.crc32c(memoryview(data)) == want
  # The check value of CRC-32C (RFC 3720).
  assert native.crc32c(b'123456789') == 0xE3069283
  assert tfrecord.crc_backend() == 'native'


def test_native_scan_matches_the_writers(native_lib, tmp_path):
  payloads = _payloads()
  for writer_cls, name in ((tfrecord.TFRecordWriter, 'ours'),
                           (jax_tfrecord.TFRecordWriter, 'theirs')):
    path = tmp_path / f'{name}.tfrecord'
    with writer_cls(str(path)) as writer:
      for p in payloads:
        writer.write(p)
    data = path.read_bytes()
    frames = native.scan_tfrecord(data)
    assert [data[o:o + n] for o, n in frames] == payloads
    assert native.scan_tfrecord(data, validate=False) == frames
    assert list(tfrecord.read_records(str(path), validate=True)) == payloads
  assert (tmp_path / 'ours.tfrecord').read_bytes() == (
      tmp_path / 'theirs.tfrecord').read_bytes()
  assert native.scan_tfrecord(b'') == []


@pytest.mark.parametrize('where', ['length_crc', 'payload', 'data_crc',
                                   'truncated'])
def test_native_scan_raises_on_corruption(native_lib, tmp_path, where):
  path = tmp_path / 'bad.tfrecord'
  with tfrecord.TFRecordWriter(str(path)) as writer:
    writer.write(b'first record')
    writer.write(b'second record')
  data = bytearray(path.read_bytes())
  if where == 'truncated':
    data = data[:-3]
  else:
    offset = {'length_crc': 9, 'payload': 14, 'data_crc': 12 + 12 + 1}[where]
    data[offset] ^= 0xFF
  with pytest.raises(IOError):
    native.scan_tfrecord(bytes(data))
  path.write_bytes(bytes(data))
  with pytest.raises(IOError, match='bad.tfrecord'):
    list(tfrecord.read_records(str(path)))


def test_native_crc_from_threads(native_lib):
  # The dataset builder checksums from its writer while worker threads
  # encode: each thread's CRCs are its own data's.
  blocks = [np.random.RandomState(i).bytes(4096 + i) for i in range(16)]
  want = [tfrecord.python_crc32c(b) for b in blocks]
  errors = []

  def work(i):
    for _ in range(50):
      if native.crc32c(blocks[i]) != want[i]:
        errors.append(i)

  threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  assert not any(t.is_alive() for t in threads)
  assert errors == []


def test_python_fallback_without_a_library(monkeypatch, tmp_path):
  monkeypatch.setattr(native, 'available', lambda: False)
  assert tfrecord.crc_backend() == 'python'
  path = str(tmp_path / 'py.tfrecord')
  with tfrecord.TFRecordWriter(path) as writer:
    writer.write(b'abc')
  assert list(jax_tfrecord.read_records(path, validate=True)) == [b'abc']
  assert list(tfrecord.read_records(path, validate=True)) == [b'abc']
  assert tfrecord.crc32c(b'123456789') == 0xE3069283


def test_a_failed_build_is_reported(monkeypatch, tmp_path):
  monkeypatch.setattr(native, '_lib', None)
  monkeypatch.setattr(native, '_failure', None)
  monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
  monkeypatch.setenv('CC', 'no-such-compiler')
  with pytest.raises(RuntimeError, match='no-such-compiler'):
    native.library()
  assert not native.available()
  assert 'no-such-compiler' in native._failure
