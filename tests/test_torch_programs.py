"""The port's compiled-program layer on the CPU, against the JAX package.

On a CUDA device the port captures its entry points as CUDA graphs
(utils/programs.py): the pair, the features and midpoint steps, each
input pair's cached tree, and the lean train step with its augmentations
on the device. Graphs exist only on the card, so here the CPU runs the
same bodies eagerly, and these tests hold what the graphs capture:

  * graphs=True on the CPU raises, and the CPU default is eager;
  * the replay accounting of ops/_kernels (a capture's record, added once
    a replay), which needs no CUDA;
  * the augmentations applied from one tensor of draws (no host sync):
    each equals the previous per-example form, and the chain equals the
    JAX package's functions; the draws of `step_generator(seed, step)`
    keep their values and order;
  * the graphs' pool: its least recently used graph dropped at its count
    bound, and every graph once it has grown past its memory budget;
    graphs captured in either order adding what the card measured with
    expandable segments (about what the largest needs alone), under a
    budget that holds it, clear nothing; a capture's span switches the
    allocator to expandable segments and back;
  * the captured step's body with what changes per step in tensors (loss
    weights from a tensor, the learning rate written into the optimizer's
    tensor before the step) against the JAX package's step over 3 steps
    across a schedule's boundary; PyTorch makes Adam capturable only on
    the card, so here it is not (chip_smoke.py holds the capturable Adam
    against a plain one);
  * the cached tree's per-pair body against the JAX package's
    expand_tree_cached_program and, bit for bit, the per-midpoint DFS.

Three JAX compiles in all: the augmentation chain, the train step, the
tree.
"""
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.data import augmentations as jax_aug
from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.training import train_lib as jax_train_lib
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.data import augmentations
from frame_interpolation_tpu_torch.inference import Interpolator, cached_tree
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.ops import _kernels, resize
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import distributed
from frame_interpolation_tpu_torch.training import train_lib
from frame_interpolation_tpu_torch.utils import programs

torch.set_num_threads(2)

ALIGN = 16
# max-abs, images in [0, 1], port vs JAX: the rotation's bilinear weights
# in f32 by two frameworks (tests/test_torch_data.py's bound)
JAX_AUG_BOUND = 1e-5
JAX_BOUND = 1e-4      # max-abs per frame, port vs JAX (f32)
JAX_PSNR_DB = 50.0
STEP_REL_BOUND = 1e-5  # loss and parameters, relative, port vs JAX (f32)
NAMES = ['random_image_rot90', 'random_flip', 'random_rotate',
         'random_reverse']


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


def _model(state):
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(state)
  return model


# ---- where graphs run ------------------------------------------------------


def test_interpolator_graphs_true_on_the_cpu_raises(tiny_state):
  default = Interpolator(tiny_state, Options.tiny(), align=ALIGN,
                         device='cpu')
  assert not default.graphs and default.programs == {}
  assert not Interpolator(tiny_state, Options.tiny(), align=ALIGN,
                          device='cpu', graphs=False).graphs
  with pytest.raises(ValueError, match='graphs=True needs a CUDA device'):
    Interpolator(tiny_state, Options.tiny(), align=ALIGN, device='cpu',
                 graphs=True)
  with pytest.raises(ValueError, match='needs a CUDA device'):
    programs.Program(lambda x: x, 'cpu', 'identity')


@pytest.mark.parametrize('case', ['summary', 'data_parallel', 'gloo'])
def test_steps_on_the_cpu_or_gloo_refuse_graphs(case, tmp_path):
  # The summary step and the data-parallel step are captured programs on
  # the card; graphs=True on the CPU raises at the first step, and so does
  # a data-parallel step over gloo (its all-reduce runs through the host).
  opts = train_lib.TrainingOptions()
  model = film_net.FilmNet(Options.tiny())
  state = train_lib.create_train_state(model, opts)
  step_fn = train_lib.make_train_step(
      losses.training_losses(['l1']), opts, with_summaries=case == 'summary',
      data_parallel=case != 'summary', graphs=True)
  if case != 'gloo':
    with pytest.raises(ValueError, match='graphs=True needs a CUDA device'):
      step_fn(state, _step_batch(), torch.Generator())
    return
  assert distributed.initialize_multihost(
      f'file://{tmp_path}/rendezvous', 1, 0, 'cpu') == 'gloo'
  try:
    with pytest.raises(ValueError, match='over gloo'):
      step_fn(state, _step_batch(), torch.Generator())
    # graphs=None takes the eager step there.
    eager = train_lib.make_train_step(losses.training_losses(['l1']), opts,
                                      with_summaries=False,
                                      data_parallel=True)
    metrics, _ = eager(state, _step_batch(), torch.Generator())
    assert state.step == 1 and eager.programs() == []
    assert np.isfinite(float(metrics['training_loss']))
  finally:
    distributed.shutdown()
  assert state.step == 1


def _step_batch(seed=0, n=2, h=32):
  rng = np.random.RandomState(seed)
  batch = {k: torch.from_numpy(rng.rand(n, h, h, 3).astype(np.float32))
           for k in ('x0', 'x1', 'y')}
  batch['time'] = torch.full((n, 1), 0.5)
  return batch


@pytest.mark.parametrize('graphs', [None, True])
def test_cpu_train_step_is_eager_and_graphs_true_raises(tiny_state, graphs):
  opts = train_lib.TrainingOptions()
  state = train_lib.create_train_state(_model(tiny_state), opts)
  step_fn = train_lib.make_train_step(losses.training_losses(['l1']), opts,
                                      with_summaries=False, graphs=graphs)
  if graphs:
    with pytest.raises(ValueError, match='graphs=True needs a CUDA device'):
      step_fn(state, _step_batch(), torch.Generator())
    assert state.step == 0
    return
  metrics, summaries = step_fn(state, _step_batch(), torch.Generator())
  assert state.step == 1 and summaries == {}
  assert step_fn.programs() == []
  assert np.isfinite(float(metrics['training_loss']))
  # The CPU optimizer keeps a float rate and is not capturable.
  group = state.optimizer.param_groups[0]
  assert isinstance(group['lr'], float) and not group['capturable']


def test_device_form_undoes_a_saved_capturable_form():
  # What a checkpoint written on the card brings: a rate tensor and the
  # capturable flag.
  param = torch.nn.Parameter(torch.ones(3))
  optimizer = torch.optim.Adam([param], lr=torch.tensor(0.5), eps=1e-7)
  param.grad = torch.ones(3)
  optimizer.step()
  optimizer.param_groups[0]['capturable'] = True
  train_lib.device_form(optimizer)
  group = optimizer.param_groups[0]
  assert group['lr'] == 0.5 and isinstance(group['lr'], float)
  assert not group['capturable']
  step = optimizer.state[param]['step']
  assert step.device.type == 'cpu' and step.dtype == torch.float32
  # A rate held in a tensor is written in place, so a graph that read
  # it reads the new value.
  rate = torch.tensor(1.0)
  optimizer.param_groups[0]['lr'] = rate
  train_lib.set_learning_rate(optimizer, 0.25)
  assert optimizer.param_groups[0]['lr'] is rate and float(rate) == 0.25


# ---- the pieces of a program that need no card -------------------------------


def test_replay_accounting_adds_a_capture_once_a_replay(monkeypatch):
  monkeypatch.setattr(_kernels, 'LAUNCHES', dict.fromkeys(_kernels.LAUNCHES,
                                                           0))
  capturing, other = 0x7f01, 0x7f02
  with _kernels.recording(capturing) as record:
    _kernels.count_launch('warp', capturing)
    _kernels.count_launch('conv3x3_c64', capturing)
    # A captured backward launches from autograd's own thread, onto the
    # forward's stream: the record still takes it.
    worker = threading.Thread(
        target=lambda: _kernels.count_launch('splat', capturing))
    worker.start()
    worker.join()
    _kernels.count_launch('warp', other)  # another stream runs eagerly
    _kernels.count_launch('warp')         # no stream named: eager
    with pytest.raises(RuntimeError, match='already being recorded'):
      with _kernels.recording(capturing):
        pass
  assert record == dict(_kernels.LAUNCHES, warp=1, conv3x3_c64=1, splat=1,
                        warp_planes=0, warp_rows=0, conv3x3_wide=0)
  assert _kernels.launch_counts()['warp'] == 2  # only the eager ones
  for _ in range(3):
    _kernels.add_replay(record)
  counts = _kernels.launch_counts()
  assert (counts['warp'], counts['conv3x3_c64'], counts['splat']) == (5, 3, 3)
  # Outside a recording, a launch on the once-capturing stream is eager.
  _kernels.count_launch('splat', capturing)
  assert _kernels.launch_counts()['splat'] == 4


def test_program_keys_tell_shapes_dtypes_and_switches_apart():
  a = torch.zeros(2, 3)
  tree = ([a, None], {'k': a.to(torch.bfloat16)})
  assert programs.signature(tree) == programs.signature(
      ([torch.ones(2, 3), None], {'k': torch.ones(2, 3, dtype=torch.bfloat16)}))
  assert programs.signature(tree) != programs.signature(
      ([torch.ones(2, 4), None], {'k': a.to(torch.bfloat16)}))
  assert programs.signature((a,)) != programs.signature([a])
  cloned = programs.tree_map(torch.clone, tree)
  assert isinstance(cloned, tuple) and isinstance(cloned[0], list)
  assert cloned[0][1] is None and cloned[0][0] is not a
  assert len(programs.tree_tensors(tree)) == 2
  saved = torch.backends.cudnn.allow_tf32
  before = programs.backend_flags()
  try:
    torch.backends.cudnn.allow_tf32 = not saved
    assert programs.backend_flags() != before
  finally:
    torch.backends.cudnn.allow_tf32 = saved
  with torch.inference_mode():
    assert programs.backend_flags() != before


class _Graph:
  """What the pool calls of a captured graph."""

  def __init__(self):
    self.live = True

  def reset(self):
    self.live = False


def _capture(nbytes):
  return programs.Capture(graph=_Graph(), inputs=[torch.zeros(1)],
                          outputs=torch.zeros(1), launches={},
                          capture_seconds=0.0, pool_bytes=nbytes)


def test_pool_drops_its_least_recently_used_graph_at_the_count_bound():
  pool = programs.Pool()
  held = {(0, i): _capture(1) for i in range(programs.MAX_GRAPHS)}
  for key, capture in held.items():
    pool.add(key, capture)
  assert pool.get((0, 0)) is held[(0, 0)]  # now the most recently used
  assert pool.get((0, 99)) is None
  pool.make_room(budget=10**9)
  # (0, 1) was the least recently used: its graph and buffers go.
  assert not held[(0, 1)].graph.live and held[(0, 1)].outputs is None
  assert held[(0, 1)].inputs is None
  assert all(c.graph.live for k, c in held.items() if k != (0, 1))
  assert len(pool.captures(0)) == programs.MAX_GRAPHS - 1
  assert list(pool.captures(0))[-1] == 0
  assert pool.clears == 0 and pool.bytes == programs.MAX_GRAPHS
  pool.add((1, 'other'), _capture(1))  # another program's key
  assert pool.captures(1) == {'other': pool.get((1, 'other'))}


def test_pool_drops_every_graph_past_its_memory_budget():
  pool = programs.Pool()
  pool.handle = ('a private pool',)
  held = [_capture(6), _capture(5)]
  for i, capture in enumerate(held):
    pool.add((0, i), capture)
  assert pool.bytes == 11
  pool.make_room(budget=11)  # at the budget: every graph stays
  assert pool.clears == 0 and all(c.graph.live for c in held)
  pool.add((1, 0), _capture(2))
  pool.make_room(budget=11)
  assert pool.clears == 1 and pool.bytes == 0 and pool.captures(0) == {}
  assert not any(c.graph.live for c in held)
  # A private pool that no graph uses is freed and never shared again: the
  # next capture makes a new one.
  assert pool.handle is None


@pytest.mark.parametrize('order', ['ascending', 'descending'])
def test_pool_graphs_in_any_order_share_what_the_largest_needs(order):
  # What 1080p bf16 pairs at batch 1, 2, 3 grew one pool by on an H100
  # 80GB, in GiB, with expandable segments: in either order about what
  # batch 3 needs alone (21.2), so under a budget that holds it nothing
  # clears. (In fixed segments: 8.2, 9.9, 14.3 ascending.)
  grown = {'ascending': (7.068, 7.109, 7.129),
           'descending': (21.203, 0.0, 0.006)}[order]
  pool = programs.Pool()
  assert pool.stream is None  # made at the first capture, one a pool
  pool.handle = ('a private pool',)
  held = []
  for i, gib in enumerate(grown):
    pool.make_room(budget=22 * 2**30)
    held.append(_capture(int(gib * 2**30)))
    pool.add((0, i), held[-1])
  pool.make_room(budget=22 * 2**30)
  assert pool.clears == 0 and all(c.graph.live for c in held)
  assert abs(pool.bytes - 21.3 * 2**30) < 0.1 * 2**30
  assert len(pool.captures(0)) == 3


@pytest.mark.parametrize('conf', ['', 'expandable_segments:True'])
def test_captures_allocate_expandable_segments(conf, monkeypatch):
  # A capture's allocations come from expandable segments, and fixed ones
  # again after it (also when it fails); a process that asked for
  # expandable segments from its start keeps them.
  settings = []
  monkeypatch.setattr(programs, '_set_allocator', settings.append)
  monkeypatch.setenv('PYTORCH_CUDA_ALLOC_CONF', conf)
  monkeypatch.delenv('PYTORCH_ALLOC_CONF', raising=False)
  with pytest.raises(RuntimeError, match='a failed capture'):
    with programs.expandable_segments():
      assert settings == ([] if conf else ['expandable_segments:True'])
      raise RuntimeError('a failed capture')
  assert settings == ([] if conf else ['expandable_segments:True',
                                       'expandable_segments:False'])


def test_resize_tables_stay_on_their_device():
  # A captured graph reads a table by address and cannot copy one from the
  # host: each is made once and kept.
  x = torch.rand(1, 6, 10, 2)
  first = resize.resize_bilinear(x, (9, 15))
  table = resize._device_table('lower', 6, 9, x.device)
  assert resize._device_table('lower', 6, 9, x.device) is table
  torch.testing.assert_close(resize.resize_bilinear(x, (9, 15)), first,
                             rtol=0, atol=0)


# ---- augmentations on the device ---------------------------------------------


def _aug_images(seed=3, n=4, h=12):
  rng = np.random.RandomState(seed)
  return {k: rng.rand(n, h, h, 3).astype(np.float32) for k in ('x0', 'x1',
                                                                'y')}


def _numpy_draws(n=4, seed=5):
  """One row per draw in the registry's order: rot90 k (every k once),
  flip, rotate's coin and uniform, reverse."""
  rng = np.random.RandomState(seed)
  return np.stack([np.arange(n) % 4, [0, 1, 1, 0], [1, 0, 1, 1],
                   rng.rand(n), [1, 1, 0, 0]]).astype(np.float32)


def _rows_of(name, draws):
  start = {'random_image_rot90': 0, 'random_flip': 1, 'random_rotate': 2,
           'random_reverse': 4}[name]
  return draws[start:start + augmentations.data_augmentations([name])[0].rows]


def _per_example(name, images, rows):
  """The previous form: each example on its own, the draws as numbers."""
  out = {k: [] for k in images}
  for i in range(rows.shape[1]):
    one = {k: torch.from_numpy(v[i]) for k, v in images.items()}
    if name == 'random_image_rot90':
      one = {k: augmentations._rot90_single(v, int(rows[0, i]))
             for k, v in one.items()}
    elif name == 'random_flip' and rows[0, i]:
      one = {k: v.flip(1) for k, v in one.items()}
    elif name == 'random_rotate':
      angle = float((torch.tensor(rows[1, i]) * 0.5 - 0.25) * math.pi)
      one = {k: augmentations.rotate_image(v, angle * rows[0, i])
             for k, v in one.items()}
    elif name == 'random_reverse' and rows[0, i]:
      one['x0'], one['x1'] = one['x1'], one['x0']
    for k, v in one.items():
      out[k].append(v.numpy())
  return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize('name', NAMES)
def test_augmentation_from_draws_equals_the_per_example_form(name):
  images = _aug_images()
  draws = _numpy_draws()
  rows = _rows_of(name, draws)
  fns = augmentations.data_augmentations([name])
  got = augmentations.apply_drawn(
      fns, torch.from_numpy(rows),
      {k: torch.from_numpy(v) for k, v in images.items()})
  want = _per_example(name, images, rows)
  for key in images:
    # The same arithmetic on each element, batched or not.
    np.testing.assert_array_equal(got[key].numpy(), want[key])
  if name == 'random_image_rot90':
    # Every k moves the content a different way.
    assert len({got['x0'][i].numpy().tobytes() for i in range(4)}) == 4


def test_augmentation_chain_equals_jax():
  images = _aug_images(seed=4)
  draws = _numpy_draws(seed=6)
  got = augmentations.apply_drawn(
      augmentations.data_augmentations(NAMES), torch.from_numpy(draws),
      {k: torch.from_numpy(v) for k, v in images.items()})
  angle = ((torch.from_numpy(draws[3]) * 0.5 - 0.25) * math.pi *
           torch.from_numpy(draws[2])).numpy()

  def one(example, k, flip, angle, swap):
    example = {n: jax_aug._rot90_single(v, k) for n, v in example.items()}
    example = {n: jnp.where(flip, jnp.flip(v, axis=1), v)
               for n, v in example.items()}
    example = {n: jax_aug.rotate_image(v, angle) for n, v in example.items()}
    x0, x1 = example['x0'], example['x1']
    example['x0'] = jnp.where(swap, x1, x0)
    example['x1'] = jnp.where(swap, x0, x1)
    return example

  want = jax.jit(jax.vmap(one))(
      images, draws[0].astype(np.int32), draws[1] > 0, angle, draws[4] > 0)
  for key in images:
    err = float(np.abs(got[key].numpy() - np.asarray(want[key])).max())
    assert err <= JAX_AUG_BOUND, (key, err)


@pytest.mark.parametrize('seed,step', [(0, 0), (3, 17)])
def test_step_draws_keep_their_values_and_order(seed, step):
  fns = augmentations.data_augmentations(NAMES)
  got = augmentations.draw_augmentations(
      fns, train_lib.step_generator(seed, step), 4)
  # The order the augmentations drew in, one call each: rot90's k, the
  # flip's coin, the rotation's coin then its uniform, the reversal's coin.
  g = train_lib.step_generator(seed, step)
  want = [torch.randint(0, 4, (4,), generator=g),
          torch.randint(0, 2, (4,), generator=g),
          torch.randint(0, 2, (4,), generator=g),
          torch.rand((4,), generator=g),
          torch.randint(0, 2, (4,), generator=g)]
  assert got.dtype == torch.float32 and tuple(got.shape) == (5, 4)
  for row, values in zip(got, want):
    assert torch.equal(row, values.float())
  # apply_data_augmentation draws them and applies them in one call.
  batch = {k: torch.from_numpy(v) for k, v in _aug_images(seed=8).items()}
  once = augmentations.apply_data_augmentation(
      fns, train_lib.step_generator(seed, step), batch)
  split = augmentations.apply_drawn(fns, got, batch)
  for key in batch:
    assert torch.equal(once[key], split[key])


# ---- the captured step's body, per-step values in tensors ---------------------


def test_capturable_step_matches_jax_across_a_schedule_boundary(tiny_state):
  # l2's weight steps from 1 to 3 after step 1: steps 0 and 1 take 1, step
  # 2 takes 3. The optimizer holds its rate in a tensor, written before
  # each step, as the captured step reads it.
  schedules = [losses.constant_schedule(1.0),
               losses.PiecewiseConstantSchedule((1,), (1.0, 3.0))]
  jax_schedules = [jax_losses.constant_schedule(1.0),
                   jax_losses.PiecewiseConstantSchedule((1,), (1.0, 3.0))]
  opts = train_lib.TrainingOptions(learning_rate=1e-3,
                                   learning_rate_decay_steps=2)
  jax_opts = jax_train_lib.TrainingOptions(learning_rate=1e-3,
                                           learning_rate_decay_steps=2)
  batch = {k: v.numpy() for k, v in _step_batch(seed=9).items()}

  model = _model(tiny_state)
  optimizer = torch.optim.Adam(model.parameters(), lr=torch.tensor(0.0),
                               eps=1e-7)
  state = train_lib.TrainState(step=0, model=model, optimizer=optimizer)
  step_fn = train_lib.make_train_step(
      losses.training_losses(['l1', 'l2'], loss_weight_schedules=schedules),
      opts, with_summaries=False)

  jax_model = jax_film_net.create_model(JaxOptions.tiny())
  jax_optimizer = jax_train_lib.create_optimizer(jax_opts)
  jax_state = jax_train_lib.create_train_state(
      params_io.to_flax_params(tiny_state), jax_optimizer)
  jax_step = jax_train_lib.make_train_step(
      jax_model, jax_losses.training_losses(
          ['l1', 'l2'], loss_weight_schedules=jax_schedules),
      jax_optimizer, with_summaries=False)

  for step in range(3):
    metrics, _ = step_fn(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                         train_lib.step_generator(0, step))
    jax_state, jax_metrics, _ = jax_step(jax_state, batch,
                                         jax.random.PRNGKey(step))
    for name in ('l1', 'k*l2', 'training_loss'):
      got, want = float(metrics[name]), float(jax_metrics[name])
      assert abs(got - want) <= STEP_REL_BOUND * abs(want), (step, name)
    assert float(optimizer.param_groups[0]['lr']) == pytest.approx(
        train_lib.learning_rate_schedule(opts)(step), rel=1e-7)
  # The boundary: l2 weighs 3 at step 2.
  total = float(metrics['l1']) + 3.0 * float(metrics['k*l2'])
  assert float(metrics['training_loss']) == pytest.approx(total, rel=1e-6)
  want = params_io.from_flax_params(jax.device_get(jax_state.params))
  for name, param in model.state_dict().items():
    scale = float(want[name].abs().max()) or 1.0
    err = float((param - want[name]).abs().max())
    assert err <= STEP_REL_BOUND * scale, (name, err, scale)


# ---- the cached tree's per-pair body -------------------------------------------


def _frames(n=3, h=30, w=44, seed=11):
  rng = np.random.RandomState(seed)
  return rng.rand(n, h, w, 3).astype(np.float32)


def _dfs_tree(interp, frames, times):
  """The per-midpoint DFS as the port ran it before the per-pair body:
  the schedule walked from the host, one step call a midpoint."""
  frames = torch.from_numpy(frames)
  n, per_pair = frames.shape[0], 2**times
  sched = cached_tree.dfs_schedule(times)
  steps = list(zip(*(sched[k].tolist() for k in
                     ('a_slot', 'b_slot', 'm_slot', 'out_pos', 'extract'))))
  out = torch.empty(((n - 1) * per_pair + 1,) + tuple(frames.shape[1:]))
  out[::per_pair] = frames
  right = interp.features_device(frames[:1])
  for i in range(n - 1):
    stack = [right, interp.features_device(frames[i + 1:i + 2])]
    stack += [None] * times
    for a_slot, b_slot, m_slot, pos, needs_features in steps:
      mid, features = interp.midpoint_from_features_device(
          stack[a_slot], stack[b_slot], frames.shape[1:3],
          with_features=needs_features)
      out[i * per_pair + pos] = mid[0]
      if needs_features:
        stack[m_slot] = features
    right = stack[1]
  return out.numpy()


def test_tree_pair_body_matches_jax_and_the_dfs(tiny_state):
  interp = Interpolator(tiny_state, Options.tiny(), align=ALIGN,
                        device='cpu')
  frames = _frames()
  got = interp.expand_tree_device(frames, 2).numpy()
  assert got.shape == (9, 30, 44, 3)
  np.testing.assert_array_equal(got, _dfs_tree(interp, frames, 2))
  # The body alone, from the first frame's features: the pair's three
  # midpoints in time order and the right frame's features.
  left = interp.features_device(frames[:1])
  mids, right = interp.tree_pair_device(left, torch.from_numpy(frames[1:2]),
                                        2)
  np.testing.assert_array_equal(mids.numpy(), got[1:4])
  for a, b in zip(programs.tree_tensors(right),
                  programs.tree_tensors(interp.features_device(frames[1:2]))):
    assert torch.equal(a, b)
  jax_interpolator = jax_interp.Interpolator(
      params_io.to_flax_params(tiny_state), JaxOptions.tiny(), align=ALIGN)
  want = np.asarray(jax_interpolator.expand_tree_device(frames, 2,
                                                        cached=True))
  for i, (a, b) in enumerate(zip(got, want)):
    assert float(np.abs(a - b).max()) <= JAX_BOUND, i
    mse = float(np.mean((a.astype(np.float64) - b)**2))
    assert 10.0 * np.log10(1.0 / max(mse, 1e-20)) >= JAX_PSNR_DB, i
