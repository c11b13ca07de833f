"""The PyTorch port's data plane and train CLI against the JAX package's.

Augmentations: each deterministic transform against its JAX counterpart
at fixed k and angle; each random one reproducible from a seeded generator
and drawn per example. TFRecords and triplet Examples: written by one
package, read by the other. Event files: written by the port, read back
through the JAX package's TFRecord reader and wire-format reader. The
train CLI: a run on the CPU over a small TFRecord leaves the reference's
run-dir layout and an export that the Interpolator loads.
"""
import json
import os
import pathlib
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.data import augmentations as jax_aug
from frame_interpolation_tpu.data import example_proto as jax_example_proto
from frame_interpolation_tpu.data import records as jax_records
from frame_interpolation_tpu.data import tfrecord as jax_tfrecord
from frame_interpolation_tpu_torch.data import augmentations, dataset
from frame_interpolation_tpu_torch.data import example_proto, records
from frame_interpolation_tpu_torch.data import tfrecord
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import images, params_io
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.utils import tensorboard

torch.set_num_threads(2)

_REPO = pathlib.Path(__file__).resolve().parent.parent


def _image(seed=0, h=12, w=12, c=3):
  return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


def _max_abs(a, b):
  return float(np.max(np.abs(np.asarray(a, np.float32) -
                             np.asarray(b, np.float32))))


# ---- deterministic transforms -----------------------------------------------


@pytest.mark.parametrize('k', [0, 1, 2, 3, 5])
def test_rot90_and_flow_rot90_match_jax(k):
  image = _image(1, 10, 14)
  got = augmentations._rot90_single(torch.from_numpy(image), k)
  assert _max_abs(got, jax_aug._rot90_single(jnp.asarray(image), k)) == 0.0
  flow = _image(2, 10, 14, 2) - 0.5
  got = augmentations.flow_rot90(torch.from_numpy(flow), k)
  assert _max_abs(got, jax_aug.flow_rot90(jnp.asarray(flow), k)) <= 1e-5


@pytest.mark.parametrize('angle', [0.0, 0.3, -0.7, np.pi / 4])
def test_rotations_match_jax(angle):
  image = _image(3, 16, 20)
  got = augmentations.rotate_image(torch.from_numpy(image), angle)
  want = jax_aug.rotate_image(jnp.asarray(image), jnp.float32(angle))
  assert _max_abs(got, want) <= 1e-5
  flow = (_image(4, 16, 20, 2) - 0.5) * 8
  got = augmentations.rotate_flow(torch.from_numpy(flow), angle)
  want = jax_aug.rotate_flow(jnp.asarray(flow), jnp.float32(angle))
  assert _max_abs(got, want) <= 1e-5
  got = augmentations.rotate_flow_vectors(torch.from_numpy(flow), angle)
  want = jax_aug.rotate_flow_vectors(jnp.asarray(flow), jnp.float32(angle))
  assert _max_abs(got, want) <= 1e-5


def test_batched_rotation_and_flow_flip_match_jax():
  images = np.stack([_image(s, 12, 12) for s in range(3)])
  angles = np.array([0.1, -0.4, 0.0], np.float32)
  got = augmentations.rotate_image(torch.from_numpy(images),
                                   torch.from_numpy(angles))
  for i in range(3):
    want = jax_aug.rotate_image(jnp.asarray(images[i]), angles[i])
    assert _max_abs(got[i], want) <= 1e-5
  flow = _image(5, 9, 11, 2) - 0.5
  assert _max_abs(augmentations.flow_flip(torch.from_numpy(flow)),
                  jax_aug.flow_flip(jnp.asarray(flow))) == 0.0


# ---- random augmentations ---------------------------------------------------

_NAMES = ['random_image_rot90', 'random_flip', 'random_rotate',
          'random_reverse']


def _same_example_batch(n=16):
  rng = np.random.RandomState(7)
  example = {k: rng.rand(1, 12, 12, 3).astype(np.float32)
             for k in ('x0', 'x1', 'y')}
  batch = {k: torch.from_numpy(np.repeat(v, n, axis=0))
           for k, v in example.items()}
  batch['time'] = torch.full((n, 1), 0.5)
  return batch


@pytest.mark.parametrize('name', _NAMES)
def test_random_augmentation_is_seeded_and_per_example(name):
  fns = augmentations.data_augmentations([name])
  batch = _same_example_batch()
  first = augmentations.apply_data_augmentation(
      fns, torch.Generator().manual_seed(3), batch)
  again = augmentations.apply_data_augmentation(
      fns, torch.Generator().manual_seed(3), batch)
  other = augmentations.apply_data_augmentation(
      fns, torch.Generator().manual_seed(4), batch)
  for key in ('x0', 'x1', 'y'):
    assert torch.equal(first[key], again[key])
    assert first[key].shape == batch[key].shape
  assert torch.equal(first['time'], batch['time'])
  # Sixteen copies of one example come out in more than one way: each
  # example draws for itself.
  key = 'x0'
  distinct = {first[key][i].numpy().tobytes() for i in range(16)}
  assert len(distinct) > 1
  assert any(not torch.equal(first[k], other[k]) for k in ('x0', 'x1', 'y'))


def test_random_augmentations_keep_each_triplet_together():
  fns = augmentations.data_augmentations(_NAMES[:3])
  batch = _same_example_batch()
  batch['y'] = batch['x0'].clone()
  out = augmentations.apply_data_augmentation(
      fns, torch.Generator().manual_seed(5), batch)
  # x0 and y of one example take the same rotations and flips.
  assert torch.equal(out['x0'], out['y'])


def test_unknown_augmentation_raises():
  with pytest.raises(AttributeError):
    augmentations.data_augmentations(['random_zoom'])


# ---- records ----------------------------------------------------------------


def _frames(seed, h=20, w=24):
  rng = np.random.RandomState(seed)
  return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(3)]


def test_tfrecords_cross_read(tmp_path):
  ours = str(tmp_path / 'ours.tfrecord')
  theirs = str(tmp_path / 'theirs.tfrecord')
  payloads = [b'', b'x', os.urandom(1000)]
  with tfrecord.TFRecordWriter(ours) as writer:
    for p in payloads:
      writer.write(p)
  with jax_tfrecord.TFRecordWriter(theirs) as writer:
    for p in payloads:
      writer.write(p)
  assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
  assert list(jax_tfrecord.read_records(ours)) == payloads
  assert list(tfrecord.read_records(theirs, validate=True)) == payloads
  assert tfrecord.sharded_filenames('a@3') == jax_tfrecord.sharded_filenames(
      'a@3')
  assert tfrecord.crc32c(payloads[2]) == jax_tfrecord.crc32c(payloads[2])


def test_corrupted_record_raises(tmp_path):
  path = tmp_path / 'bad.tfrecord'
  with tfrecord.TFRecordWriter(str(path)) as writer:
    writer.write(b'payload')
  data = bytearray(path.read_bytes())
  data[14] ^= 0xFF
  path.write_bytes(bytes(data))
  with pytest.raises(IOError):
    list(tfrecord.read_records(str(path)))


def test_triplet_examples_cross_read():
  frames = _frames(0)
  ours = records.make_triplet_example(frames, path='clip/0001')
  theirs = jax_records.make_triplet_example(frames, path='clip/0001')
  assert (example_proto.decode_example(theirs) ==
          jax_example_proto.decode_example(ours))
  got = records.parse_triplet_example(theirs, with_path=True)
  want = jax_records.parse_triplet_example(ours, with_path=True)
  assert got['path'] == want['path'] == 'clip/0001'
  for key in ('x0', 'y', 'x1'):
    np.testing.assert_array_equal(got[key], want[key])
  features = {'floats': [0.5, -2.0], 'ints': [3, -1], 'bytes': [b'ab']}
  assert (jax_example_proto.decode_example(
      example_proto.encode_example(features)) == features)


def test_training_iterator_batches_crops(tmp_path):
  path = str(tmp_path / 'train.tfrecord')
  with tfrecord.TFRecordWriter(path) as writer:
    for seed in range(3):
      writer.write(records.make_triplet_example(_frames(seed)))
  it = dataset.create_training_iterator(
      [dataset.TrainingSource(path, 16)], batch_size=2, shuffle_buffer=2,
      prefetch=0)
  batch = next(it)
  assert batch['x0'].shape == batch['y'].shape == (2, 16, 16, 3)
  assert batch['time'].shape == (2, 1)
  evals = list(dataset.eval_dataset(path))
  assert len(evals) == 3 and evals[0]['x0'].shape == (1, 20, 24, 3)


# ---- event files ------------------------------------------------------------


def _read_events(path):
  """Events as (step, tag, kind, value) through the JAX package's TFRecord
  reader and wire-format reader."""
  out = []
  for record in jax_tfrecord.read_records(path, validate=True):
    reader = jax_example_proto._Reader(record)
    step, values = None, []
    while not reader.eof():
      key = reader.varint()
      field, wire = key >> 3, key & 7
      if field == 2 and wire == 0:
        step = reader.varint()
      elif field == 5 and wire == 2:
        summary = jax_example_proto._Reader(reader.bytes_())
        while not summary.eof():
          skey = summary.varint()
          if skey >> 3 == 1 and skey & 7 == 2:
            values.append(summary.bytes_())
          else:
            summary.skip(skey & 7)
      else:
        reader.skip(wire)
    for value in values:
      v = jax_example_proto._Reader(value)
      tag, kind, payload = None, None, None
      while not v.eof():
        vkey = v.varint()
        field, wire = vkey >> 3, vkey & 7
        if field == 1 and wire == 2:
          tag = v.bytes_().decode()
        elif field == 2 and wire == 5:
          kind = 'scalar'
          payload = struct.unpack('<f', v.data[v.pos:v.pos + 4])[0]
          v.pos += 4
        elif field in (4, 5) and wire == 2:
          kind = 'image' if field == 4 else 'histogram'
          payload = v.bytes_()
        else:
          v.skip(wire)
      out.append((step, tag, kind, payload))
  return out


def test_event_files_read_back_through_jax(tmp_path):
  writer = tensorboard.SummaryWriter(str(tmp_path))
  writer.scalar('losses/l1', 0.25, 7)
  writer.image('training/y', _image(8, 6, 5), 7)
  writer.histogram('training/y_h', np.arange(10.0), 7)
  writer.close()
  second = tensorboard.SummaryWriter(str(tmp_path))
  second.scalar('steps/sec', 3.5, 8)
  second.close()
  files = sorted(tmp_path.glob('events.out.tfevents.*'))
  assert len(files) == 2
  events = [e for f in files for e in _read_events(str(f))]
  assert (7, 'losses/l1', 'scalar', 0.25) in events
  assert (8, 'steps/sec', 'scalar', 3.5) in events
  kinds = {(tag, kind) for _, tag, kind, _ in events if tag}
  assert ('training/y', 'image') in kinds
  assert ('training/y_h', 'histogram') in kinds
  image = next(p for _, tag, _, p in events if tag == 'training/y')
  png = jax_example_proto._Reader(image)
  fields = {}
  while not png.eof():
    key = png.varint()
    fields[key >> 3] = png.bytes_() if key & 7 == 2 else png.varint()
  assert (fields[1], fields[2], fields[3]) == (6, 5, 3)
  decoded = jax_records.decode_image(fields[4])
  np.testing.assert_array_equal(np.round(decoded * 255).astype(np.uint8),
                                images.to_uint8(_image(8, 6, 5)))


# ---- the train CLI ----------------------------------------------------------


def test_train_cli_on_cpu_leaves_the_run_layout(tmp_path):
  data = str(tmp_path / 'train.tfrecord')
  with tfrecord.TFRecordWriter(data) as writer:
    for seed in range(4):
      writer.write(records.make_triplet_example(_frames(seed, 136, 144)))
  cmd = [sys.executable, '-m', 'frame_interpolation_tpu_torch.cli.train',
         '--device', 'cpu', '--train_file', data, '--batch_size', '1',
         '--crop_size', '128', '--num_steps', '2', '--save_interval', '1',
         '--base_folder', str(tmp_path / 'runs'), '--label', 'run0']
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False,
                        timeout=600, cwd=_REPO)
  assert proc.returncode == 0, proc.stderr[-3000:]
  run = tmp_path / 'runs' / 'run0'
  config = json.loads((run / 'config.json').read_text())
  assert config['name'] == 'film_net-L1'
  assert config['dataset']['batch_size'] == 8  # the preset; the flag wins
  assert sorted(p.name for p in (run / 'train').glob('ckpt-*.pt')) == [
      'ckpt-1.pt', 'ckpt-2.pt']
  assert list((run / 'train').glob('events.out.tfevents.*'))
  state_dict, options = params_io.load_state_bundle(str(run / 'saved_model'))
  assert options == Options.film_net_released()
  frames = np.random.RandomState(0).rand(2, 1, 64, 64, 3).astype(np.float32)
  out = Interpolator(state_dict, options, align=64, device='cpu')(
      frames[0], frames[1], np.full((1,), 0.5, np.float32))
  assert out.shape == (1, 64, 64, 3) and np.isfinite(out).all()


@pytest.mark.parametrize('flag', ['--gin_config=a.gin',
                                  '--vgg_model_file=vgg.mat',
                                  '--eval_files=a',
                                  '--experiment=film_net-VGG'])
def test_train_cli_refuses_flags_of_later_slices(flag, tmp_path,
                                                 monkeypatch):
  # Every flag is ported; each refuses what it cannot run with: a missing
  # gin file, a missing .mat, --eval_files without as many --eval_names, a
  # VGG experiment without --vgg_model_file.
  from frame_interpolation_tpu_torch.cli import train
  monkeypatch.chdir(tmp_path)  # a.gin and vgg.mat do not exist here
  extra, error = {
      '--gin_config=a.gin': ([], FileNotFoundError),
      '--vgg_model_file=vgg.mat': (['--experiment=film_net-Style'],
                                   FileNotFoundError),
      '--eval_files=a': ([], SystemExit),
      '--experiment=film_net-VGG': ([], ValueError),
  }[flag]
  with pytest.raises(error):
    train.main(['--base_folder', str(tmp_path / 'runs'), '--device=cpu',
                '--train_file=a.tfrecord', flag] + extra)
