"""TF's tensor bundle read by the PyTorch port without TensorFlow.

io/tf_bundle.py against files TensorFlow itself writes: raw bundles of
every dtype the reader decodes, a table spanning several blocks, the
object graph of an object-based checkpoint, the `checkpoint` state file;
corrupted and compressed files raise. And the stand-in release that
chip_smoke.py writes on the card (write_tf_checkpoint, both forms) is read
by tf.train.load_checkpoint to the same arrays and variable names, so the
card exercises files TensorFlow accepts. No JAX here.
"""
import os
import shutil
import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')

from tensorflow.core.protobuf import trackable_object_graph_pb2  # noqa: E402

import chip_smoke  # noqa: E402  (the repo root is on sys.path under pytest)
from frame_interpolation_tpu_torch.data import tfrecord  # noqa: E402
from frame_interpolation_tpu_torch.io import tf_bundle  # noqa: E402
from frame_interpolation_tpu_torch.models import (create_model,  # noqa: E402
                                                  init_params)
from frame_interpolation_tpu_torch.options import Options  # noqa: E402

torch.set_num_threads(2)

# Long keys that differ early, so the entries fill more than one of TF's
# 256 KiB table blocks.
LONG_KEYS = 600
SMALL = Options(pyramid_levels=4, fusion_pyramid_levels=3,
                specialized_levels=2, flow_convs=(2, 2, 2),
                flow_filters=(8, 16, 16), sub_levels=3, filters=4)


def _raw_tensors():
  rng = np.random.RandomState(0)
  tensors = {f'{i:04d}/' + 'k' * 900: rng.rand(3, i % 5 + 1).astype(
      np.float32) for i in range(LONG_KEYS)}
  tensors.update({
      'f32': rng.randn(2, 3, 4).astype(np.float32),
      'f16': rng.randn(4, 3).astype(np.float16),
      'i32': np.array([1, -2, 2**31 - 1], np.int32),
      'i64': np.arange(7, dtype=np.int64) - 2**40,
      'bf16': rng.randn(5, 2).astype(np.float32),
      'scalar': np.array(3.5, np.float32),
      'empty': np.zeros((0, 3), np.float32),
      'str': np.array(b'hello world'),
      'strs': np.array([b'a', b'', b'xyz' * 100]),
  })
  return tensors


@pytest.fixture(scope='module')
def raw_bundle(tmp_path_factory):
  """A bundle TF's SaveV2 wrote: (prefix, {key: what TF reads back})."""
  prefix = str(tmp_path_factory.mktemp('raw') / 'raw')
  tensors = _raw_tensors()
  values = [tf.constant(v, tf.bfloat16) if k == 'bf16' else v
            for k, v in tensors.items()]
  tf.raw_ops.SaveV2(prefix=prefix, tensor_names=list(tensors),
                    shape_and_slices=[''] * len(tensors), tensors=values)
  reader = tf.train.load_checkpoint(prefix)
  return prefix, {k: reader.get_tensor(k) for k in tensors}


class _Net(tf.Module):

  def __init__(self):
    super().__init__()
    rng = np.random.RandomState(1)
    self.convs = [tf.Variable(rng.rand(3, 3, 2, 4).astype(np.float32),
                              name=f'net/conv_{i}/kernel') for i in range(3)]
    self.bias = tf.Variable(rng.rand(4).astype(np.float32), name='net/bias')
    self.steps = tf.Variable(np.int64(7), name='steps')


@pytest.fixture(scope='module')
def object_checkpoint(tmp_path_factory):
  """tf.train.Checkpoint(model=_Net()) saved twice: (directory, prefix of
  the newest)."""
  directory = tmp_path_factory.mktemp('ckpt')
  ckpt = tf.train.Checkpoint(model=_Net())
  ckpt.save(str(directory / 'ckpt'))
  prefix = ckpt.save(str(directory / 'ckpt'))
  return str(directory), prefix


def _tf_object_graph(prefix):
  graph = trackable_object_graph_pb2.TrackableObjectGraph()
  graph.ParseFromString(tf.train.load_checkpoint(prefix).get_tensor(
      tf_bundle.OBJECT_GRAPH_KEY))
  return [(a.full_name, a.checkpoint_key) for node in graph.nodes
          for a in node.attributes]


def test_reads_every_dtype_tf_wrote_bit_for_bit(raw_bundle):
  prefix, want = raw_bundle
  with open(prefix + '.index', 'rb') as f:
    assert len(tf_bundle.index_handles(f.read())) > 1  # several blocks
  reader = tf_bundle.BundleReader(prefix)
  assert reader.keys() == sorted(want)
  for key, value in want.items():
    got = reader.read(key)
    if key == 'bf16':  # decoded exactly, as float32
      assert reader.dtype(key) == 'bfloat16'
      value = value.astype(np.float32)
    if isinstance(value, bytes):  # TF returns a string scalar as bytes
      value = np.array(value, dtype=object)
    assert got.shape == value.shape == reader.shape(key), key
    if value.dtype == object:
      assert got.dtype == object and got.tolist() == value.tolist(), key
    else:
      assert got.dtype == value.dtype, key
      assert got.tobytes() == value.tobytes(), key
  assert reader.dtype('strs') == 'string' and reader.dtype('f16') == 'float16'


def test_object_graph_and_latest_checkpoint_match_tf(object_checkpoint):
  directory, prefix = object_checkpoint
  assert tf_bundle.latest_checkpoint(directory) == tf.train.latest_checkpoint(
      directory) == prefix
  reader = tf_bundle.BundleReader(prefix)
  pairs = tf_bundle.object_graph(reader)
  assert pairs == _tf_object_graph(prefix)
  names = dict(pairs)
  assert names['net/conv_2/kernel'] == ('model/convs/2/.ATTRIBUTES/'
                                        'VARIABLE_VALUE')
  assert reader.read(names['steps']) == 7
  assert reader.read(names['save_counter']) == 2


def test_latest_checkpoint_follows_the_state_file(object_checkpoint,
                                                  tmp_path):
  directory, prefix = object_checkpoint
  copy = tmp_path / 'copy'
  shutil.copytree(directory, copy)
  state = copy / 'checkpoint'
  name = os.path.basename(prefix)
  for text, want in (
      (f'model_checkpoint_path: "{name}"\n', str(copy / name)),
      (f'model_checkpoint_path: "{copy / name}"\n', str(copy / name)),
      ('model_checkpoint_path: "ckpt-9"\n', None),  # no such index
  ):
    state.write_text(text)
    assert tf_bundle.latest_checkpoint(str(copy)) == want
    assert tf.train.latest_checkpoint(str(copy)) == want
  state.unlink()
  assert tf_bundle.latest_checkpoint(str(copy)) is None
  assert tf.train.latest_checkpoint(str(copy)) is None


def _copy_bundle(prefix, tmp_path):
  target = str(tmp_path / 'bundle')
  for suffix in ('.index', '.data-00000-of-00001'):
    shutil.copyfile(prefix + suffix, target + suffix)
  return target


def _flip(path, offset):
  with open(path, 'r+b') as f:
    f.seek(offset)
    byte = f.read(1)[0]
    f.seek(offset)
    f.write(bytes([byte ^ 0x20]))


@pytest.mark.parametrize('where', ['float entry', 'string lengths',
                                   'string bytes', 'index block'])
def test_a_flipped_byte_raises(where, raw_bundle, tmp_path):
  prefix = _copy_bundle(raw_bundle[0], tmp_path)
  reader = tf_bundle.BundleReader(prefix)
  data = tf_bundle.data_path(prefix, 0, 1)
  if where == 'index block':
    _flip(prefix + '.index', 100)
    with pytest.raises(tf_bundle.BundleError, match='checksum'):
      tf_bundle.BundleReader(prefix)
    return
  key, skip = {'float entry': ('f32', 5), 'string lengths': ('strs', 0),
               'string bytes': ('strs', 10)}[where]
  _flip(data, reader.entry(key).offset + skip)
  with pytest.raises(tf_bundle.BundleError, match='checksum'):
    reader.read(key)
  reader.read('i64')  # the other entries still read


def test_a_compressed_block_raises(raw_bundle, tmp_path):
  # TF's reader takes snappy blocks; a bundle's writer never makes them.
  prefix = _copy_bundle(raw_bundle[0], tmp_path)
  with open(prefix + '.index', 'rb') as f:
    data = bytearray(f.read())
  offset, size = tf_bundle.index_handles(bytes(data))[0]
  data[offset + size] = 1
  crc = tfrecord.masked_crc32c(bytes(data[offset:offset + size + 1]))
  struct.pack_into('<I', data, offset + size + 1, crc)
  with open(prefix + '.index', 'wb') as f:
    f.write(data)
  with pytest.raises(tf_bundle.BundleError, match='snappy-compressed'):
    tf_bundle.BundleReader(prefix)


def test_other_dtypes_and_missing_files_raise(tmp_path):
  prefix = str(tmp_path / 'f64')
  tf.raw_ops.SaveV2(prefix=prefix, tensor_names=['f64'],
                    shape_and_slices=[''],
                    tensors=[np.ones((2, 2), np.float64)])
  reader = tf_bundle.BundleReader(prefix)
  assert reader.shape('f64') == (2, 2) and reader.dtype('f64') == 'DT_2'
  with pytest.raises(tf_bundle.BundleError, match='unsupported dtype DT_2'):
    reader.read('f64')
  with pytest.raises(KeyError):
    reader.read('nope')
  with pytest.raises(FileNotFoundError):
    tf_bundle.BundleReader(str(tmp_path / 'missing'))
  with open(prefix + '.index', 'r+b') as f:
    f.seek(-1, os.SEEK_END)
    f.write(b'\0')  # the magic's last byte
  with pytest.raises(tf_bundle.BundleError, match='magic'):
    tf_bundle.BundleReader(prefix)


@pytest.mark.parametrize('form', ['checkpoint', 'saved_model'])
def test_the_smoke_writer_writes_what_tf_reads(form, tmp_path):
  state = init_params(create_model(SMALL),
                      torch.Generator().manual_seed(0)).state_dict()
  path = str(tmp_path / form)
  chip_smoke.write_tf_checkpoint(path, state, SMALL, form)
  if form == 'checkpoint':
    prefix = tf.train.latest_checkpoint(path)
    assert prefix == tf_bundle.latest_checkpoint(path)
  else:
    prefix = os.path.join(path, 'variables', 'variables')
  reader = tf.train.load_checkpoint(prefix)
  ours = tf_bundle.BundleReader(prefix)
  keys = set(reader.get_variable_to_shape_map())
  assert keys == set(ours.keys())
  for key in keys - {tf_bundle.OBJECT_GRAPH_KEY}:
    assert reader.get_tensor(key).tobytes() == ours.read(key).tobytes(), key
  graph = _tf_object_graph(prefix)
  assert graph == tf_bundle.object_graph(ours)
  names = dict(graph)
  want = len(state) + (2 if form == 'checkpoint' else 0)
  assert len(names) == want == len(keys) - 1
  # The reference's names, the fusion convs as Keras auto-names.
  fusion = sorted(name for name in names if name.startswith('fusion/'))
  assert fusion[:3] == ['fusion/conv2d/bias', 'fusion/conv2d/kernel',
                        'fusion/conv2d_1/bias']
  kernel = state['feat_net.sub_extractor.cfeat_conv_0.weight']
  np.testing.assert_array_equal(
      reader.get_tensor(names['feat_net/sub_extractor/cfeat_conv_0/kernel']),
      kernel.numpy().transpose(2, 3, 1, 0))
