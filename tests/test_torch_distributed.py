"""Data-parallel training across processes (parallel/distributed.py), on
the CPU.

The process-group helpers as the JAX package's tests/test_distributed.py
has them (no-op init, the batch slice); two ranks over gloo at batch 4
each against one process at batch 8, two steps with the augmentations
(every parameter to 1e-6); and `cli.train` on two ranks, where rank 0
leaves the run directory and rank 1 writes nothing. The ranks meet
through a `file://` store in the test's own directory, so tests running
at once never share a rendezvous. No JAX compile.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.data import records, tfrecord
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import distributed
from frame_interpolation_tpu_torch.training import train_lib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AUGMENTATIONS = ('random_image_rot90', 'random_flip', 'random_rotate',
                  'random_reverse')
GLOBAL_BATCH, STEPS = 8, 2


# ---- the helpers -----------------------------------------------------------------


def test_initialize_unconfigured_is_noop():
  assert distributed.initialize_multihost(None, None, None) is None
  assert not distributed.is_initialized()
  assert (distributed.world_size(), distributed.rank()) == (1, 0)


def test_initialize_needs_every_argument():
  with pytest.raises(ValueError, match='process_id'):
    distributed.initialize_multihost('localhost:1234', 2, None)
  with pytest.raises(ValueError, match='not in'):
    distributed.initialize_multihost('localhost:1234', 2, 2)


def test_process_batch_slice_single_process():
  assert distributed.process_batch_slice(8) == (0, 8)
  assert distributed.process_batch_slice(3) == (0, 3)


def test_process_batch_slice_divisibility(monkeypatch):
  monkeypatch.setattr(distributed, 'world_size', lambda: 4)
  monkeypatch.setattr(distributed, 'rank', lambda: 3)
  assert distributed.process_batch_slice(8) == (6, 2)
  with pytest.raises(ValueError, match='must divide'):
    distributed.process_batch_slice(6)


def test_backend_and_device_choice(monkeypatch):
  monkeypatch.delenv('LOCAL_WORLD_SIZE', raising=False)
  monkeypatch.delenv('LOCAL_RANK', raising=False)
  assert distributed.choose_backend('cpu', 2) == 'gloo'
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
  assert distributed.choose_backend('cuda', 1) == 'nccl'
  assert distributed.choose_backend('cuda', 2) == 'nccl'
  # Two ranks on one card, or more ranks than cards on this host.
  assert distributed.choose_backend('cuda', 3) == 'gloo'
  monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
  assert distributed.choose_backend('cuda', 16) == 'nccl'
  monkeypatch.setattr(distributed, 'rank', lambda: 3)
  assert distributed.rank_device('cuda') == torch.device('cuda', 1)
  monkeypatch.setenv('LOCAL_RANK', '0')
  assert distributed.rank_device('cuda') == torch.device('cuda', 0)
  assert distributed.rank_device('cpu') == torch.device('cpu')


# ---- two ranks against one process ------------------------------------------------


def _global_batches():
  """Seeded global batches of tiny moving-noise triplets."""
  rng = np.random.RandomState(0)
  for _ in range(STEPS):
    frames = rng.rand(3, GLOBAL_BATCH, 32, 32, 3).astype(np.float32)
    yield {'x0': frames[0], 'x1': frames[1], 'y': frames[2],
           'time': np.full((GLOBAL_BATCH, 1), 0.5, np.float32)}


def _train_steps(data_parallel):
  """STEPS lean train steps of the tiny config from seed-0 weights on the
  global batches; returns (state_dict, losses, last gradients)."""
  options = Options.tiny()
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(0))
  opts = train_lib.TrainingOptions(learning_rate=1e-3)
  step_fn = train_lib.make_train_step(
      losses.training_losses(['l1']), opts, _AUGMENTATIONS,
      with_summaries=False, data_parallel=data_parallel)
  state = train_lib.create_train_state(model, opts)
  seen = []
  for batch in _global_batches():
    metrics, _ = step_fn(state, train_lib.batch_to_device(
        batch, torch.device('cpu')),
                         train_lib.step_generator(0, state.step))
    seen.append(float(metrics['training_loss']))
  grads = {n: p.grad.clone() for n, p in model.named_parameters()}
  return model.state_dict(), seen, grads


def _rank_main(rank, init_url, out_dir):
  torch.set_num_threads(1)
  distributed.initialize_multihost(init_url, 2, rank, device_type='cpu')
  try:
    state, seen, grads = _train_steps(data_parallel=True)
    torch.save({'state': state, 'losses': seen, 'grads': grads},
               os.path.join(out_dir, f'rank{rank}.pt'))
  finally:
    distributed.shutdown()


def test_two_gloo_ranks_equal_one_process_on_the_global_batch(tmp_path):
  init_url = f'file://{tmp_path / "rendezvous"}'
  mp.spawn(_rank_main, args=(init_url, str(tmp_path)), nprocs=2,
           join=True)
  torch.set_num_threads(2)
  want_state, want_losses, want_grads = _train_steps(data_parallel=False)
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=True)
           for r in range(2)]
  for got in ranks:
    # The logged loss is the mean over the ranks: the global batch's.
    np.testing.assert_allclose(got['losses'], want_losses, rtol=1e-6)
    for name, value in want_state.items():
      assert float((got['state'][name] - value).abs().max()) <= 1e-6, name
    # The last step's averaged gradients: the ranks sum their halves of
    # the batch in another order than one process (and from weights that
    # moved by the first step's rounding), so f32 reassociation over some
    # 24,576 terms a loss.
    for name, g in want_grads.items():
      scale = float(g.abs().max())
      assert float((got['grads'][name] - g).abs().max()) <= 1e-4 * scale, (
          name)
  # One all-reduce gives every rank the same bits.
  for name in want_state:
    assert torch.equal(ranks[0]['state'][name], ranks[1]['state'][name])


# ---- the CLI -----------------------------------------------------------------------

_TINY_GIN = """
model.name = 'film_net'
film_net.pyramid_levels = 4
film_net.fusion_pyramid_levels = 3
film_net.specialized_levels = 2
film_net.sub_levels = 3
film_net.flow_convs = [1, 1, 1]
film_net.flow_filters = [8, 8, 8]
film_net.filters = 4
training.learning_rate = 0.0001
training.num_steps = 2
training_dataset.batch_size = 2
training_dataset.crop_size = 32
data_augmentation.names = ['random_image_rot90', 'random_flip',
                           'random_rotate', 'random_reverse']
training_losses.loss_names = ['l1']
training_losses.loss_weights = [1.0]
"""


def test_train_cli_on_two_ranks(tmp_path):
  data = str(tmp_path / 'train.tfrecord')
  rng = np.random.RandomState(0)
  with tfrecord.TFRecordWriter(data) as writer:
    for _ in range(4):
      writer.write(records.make_triplet_example(
          [rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
           for _ in range(3)]))
  gin = tmp_path / 'tiny.gin'
  gin.write_text(_TINY_GIN)
  init_url = f'file://{tmp_path / "rendezvous"}'
  procs = []
  for rank in range(2):
    cmd = [sys.executable, '-m', 'frame_interpolation_tpu_torch.cli.train',
           '--device', 'cpu', '--gin_config', str(gin), '--train_file', data,
           '--save_interval', '1', '--base_folder',
           str(tmp_path / f'runs{rank}'), '--label', 'run0',
           '--coordinator_address', init_url, '--num_processes', '2',
           '--process_id', str(rank)]
    procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  cwd=_REPO))
  outputs = [p.communicate(timeout=300) for p in procs]
  for p, (_, err) in zip(procs, outputs):
    assert p.returncode == 0, err[-3000:]
  run = tmp_path / 'runs0' / 'run0'
  assert json.loads((run / 'config.json').read_text())['dataset'][
      'batch_size'] == 2
  assert sorted(p.name for p in (run / 'train').glob('ckpt-*.pt')) == [
      'ckpt-1.pt', 'ckpt-2.pt']
  assert list((run / 'train').glob('events.out.tfevents.*'))
  state_dict, options = params_io.load_state_bundle(str(run / 'saved_model'))
  assert options == Options.tiny()
  assert 'step 2: ' in outputs[0][0] and 'step 2: ' not in outputs[1][0]
  # Rank 1 writes nothing: not even its run directory.
  assert not (tmp_path / 'runs1').exists()
