"""The training loop of the film_net interpolator (PyTorch, one device).

Port of frame_interpolation_tpu/training/train_lib.py (itself the
reference's training/train.py and train_lib.py):

  * Adam with staircase exponential learning-rate decay (train.py:99-104);
    the update with index n (from 0) uses schedule(n), as optax counts;
  * a weighted multi-loss objective whose weights depend on the step
    (train_lib.py:46-60);
  * checkpoint save and restore-and-resume every `save_interval` steps,
    keeping `max_to_keep` (train_lib.py:194-210, 243-244), with the
    model's options.json beside them, which cli/build_params reads;
  * TensorBoard scalars, images and histograms, and steps/sec
    (train_lib.py:212-214, 254-269) from utils/profiling.StepTimer;
  * an export of the trained weights at the end (train_lib.py:276-280), as
    the port's state bundle (io/params_io.save_state_bundle);
  * an `eval_fn(state, step)` hook at each save interval, which the train
    CLI fills with training/eval_lib.eval_loop (train_lib.py:313-314);
  * a profiler trace of a window of steps when `profile_dir` is set: steps
    [profile_start_step, profile_start_step + profile_num_steps), written
    by utils/profiling as `<profile_dir>/steps_<first>_<end>.json`, closed
    early when the run ends (or fails) inside the window.

The model, the batch and the augmentations live on one device; on CUDA the
warp and the extractor's conv stacks run the hand-written kernels forward
and backward (ops/warp.py, ops/conv_stack.py).

On a CUDA device the step is one captured program (utils/programs.py), as
the JAX package's step is one jitted program with the augmentations on
the device: augmentation, forward, weighted losses, backward (with the
data-parallel all-reduce) and Adam replay as one CUDA graph. What changes
from step to step reaches the graph through static device tensors
written before each replay: the batch, the loss weights and the
augmentations' draws (made on the host from the step's generator, in the
eager order, and copied over as one small tensor), and the learning rate,
which a capturable Adam reads from a device tensor (`create_optimizer`,
`set_learning_rate`). As the JAX package compiles two variants, the lean
step and the summary step (logging steps, which also return the images)
are two programs; the loop gives them one memory pool, and both update
the same parameters, optimizer state and learning-rate tensor.
`graphs=False` is the eager path throughout; the CPU always takes it, and
so does a data-parallel step over gloo, whose collectives run through the
host and cannot be captured (graphs=True raises there).

Data-parallel across processes (parallel/distributed.py): where a process
group is initialized, every rank reads the same global batch from the
same seeded iterator, augments all of it with the step's generator (so
its examples get the draws one process would give them), keeps its slice
(`process_batch_slice`) and runs the forward and backward on it. Then one
all-reduce of the flattened gradients and losses averages them over the
ranks, before Adam: an all-reduce by hand rather than
DistributedDataParallel, because the step is then the single-process step
plus one collective (the model, its state_dict names and its checkpoints
stay as they are, and no bucketing hook reorders the sums), at the cost
of not overlapping the exchange with the backward. Rank 0 alone writes
the summaries, checkpoints, export and eval; every rank restores, and the
ranks meet at a barrier after each save.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import losses as losses_lib
from ..data import augmentations as augmentations_lib
from ..io import params_io
from ..models.film_net import FilmNet, init_params
from ..options import Options
from ..parallel import distributed
from ..utils import profiling, programs, tensorboard


@dataclasses.dataclass(frozen=True)
class TrainingOptions:
  """gin `training.*` parity (training/train.py:63-74 + the config files)."""
  learning_rate: float = 1e-4
  learning_rate_decay_steps: int = 750000
  learning_rate_decay_rate: float = 0.464158
  learning_rate_staircase: bool = True
  num_steps: int = 3000000
  save_interval: int = 3000
  timing_interval: int = 100
  max_to_keep: int = 10


def learning_rate_schedule(opts: TrainingOptions) -> Callable[[int], float]:
  """tf.keras ExponentialDecay parity (staircase floor-divides the step)."""

  def schedule(step: int) -> float:
    exponent = step / opts.learning_rate_decay_steps
    if opts.learning_rate_staircase:
      exponent = math.floor(exponent)
    return opts.learning_rate * opts.learning_rate_decay_rate**exponent

  return schedule


def create_optimizer(parameters, opts: TrainingOptions) -> torch.optim.Adam:
  """Adam with the reference's epsilon (the Keras default, 1e-7).

  The learning rate is set before every update from
  `learning_rate_schedule` (see `make_train_step`). On a CUDA device the
  optimizer is capturable and its rate an f32 device tensor (`device_form`),
  so a captured step reads the rate written before each replay.
  """
  optimizer = torch.optim.Adam(parameters, lr=learning_rate_schedule(opts)(0),
                               eps=1e-7)
  device_form(optimizer)
  return optimizer


def device_form(optimizer: torch.optim.Optimizer) -> None:
  """Puts each param group in its device's form, in place: on CUDA
  capturable (the step counts on the device) with the learning rate an f32
  device tensor; elsewhere not capturable, the rate a float. Also after a
  load_state_dict, which brings the saved form."""
  for group in optimizer.param_groups:
    device = group['params'][0].device
    cuda = device.type == 'cuda'
    lr = float(group['lr'])
    group['capturable'] = cuda
    group['lr'] = (torch.tensor(lr, dtype=torch.float32, device=device)
                   if cuda else lr)
    for p in group['params']:
      state = optimizer.state.get(p, {})
      if 'step' in state:
        state['step'] = state['step'].to(
            device=device if cuda else 'cpu', dtype=torch.float32)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
  """Writes `lr` into every param group: into its device tensor where it
  has one (no sync), else as a float."""
  for group in optimizer.param_groups:
    if isinstance(group['lr'], torch.Tensor):
      group['lr'].fill_(lr)
    else:
      group['lr'] = lr


@dataclasses.dataclass
class TrainState:
  """The model, its optimizer and the number of updates made so far."""
  step: int
  model: FilmNet
  optimizer: torch.optim.Optimizer


def create_train_state(model: FilmNet, opts: TrainingOptions) -> TrainState:
  return TrainState(step=0, model=model,
                    optimizer=create_optimizer(model.parameters(), opts))


# Aux model outputs summarized as images when present: the reference's
# extra_images set (training/train_lib.py:88-93).
_EXTRA_IMAGE_SUMMARIES = (
    'importance0', 'importance1', 'x0_warped', 'x1_warped', 'fg_image',
    'bg_image', 'fg_alpha', 'x1_unfiltered_warped')

Losses = Mapping[str, Tuple[losses_lib.LossFn, losses_lib.WeightFn]]
Batch = Dict[str, torch.Tensor]


def make_train_step(
    losses: Losses,
    opts: TrainingOptions,
    augmentation_names: Sequence[str] = (),
    with_summaries: bool = True,
    data_parallel: bool = False,
    graphs: Optional[bool] = None,
    pool: Optional[programs.Pool] = None,
) -> Callable[[TrainState, Batch, torch.Generator],
              Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
  """Builds the train step.

  Returns step_fn(state, batch, generator) -> (metrics, summaries): it
  augments the batch (drawing from `generator`), runs the forward, the
  weighted losses and the backward, and makes one Adam update with the
  learning rate of schedule(state.step); then state.step grows by one.
  `batch` holds (B, H, W, 3) tensors 'x0', 'x1', 'y' and a (B, 1) 'time'
  on the model's device. `metrics` holds every loss and 'training_loss'
  (detached 0-d tensors). `with_summaries=False` is the lean variant,
  which keeps no images: `summaries` is then empty. With
  `data_parallel`, `batch` is the global batch: the step augments all of
  it, trains on this rank's slice, and averages the gradients and the
  metrics over the ranks (the module docstring says how).

  `graphs`: capture the step as a CUDA graph (None: on a CUDA device,
  and for the data-parallel step only over NCCL). Every step on the CPU
  runs eagerly, and so does the data-parallel step over gloo: gloo's
  all-reduce goes through the host, which a graph cannot hold. graphs=True
  raises there at the first step. The graph is captured at the first step
  of each batch shape, after that step ran eagerly as its warm-up, for the
  state's model and optimizer; a step with another model or optimizer
  captures anew. `pool`: the graphs' memory pool, to share with the other
  variant's step (utils/programs.Pool).
  """
  augmentations = augmentations_lib.data_augmentations(augmentation_names)
  schedule = learning_rate_schedule(opts)
  bound = {}  # the state's (model, optimizer) -> its program or None

  def body(model: FilmNet, optimizer: torch.optim.Optimizer, batch: Batch,
           scalars: torch.Tensor):
    """The step on device tensors alone: `scalars` holds the loss weights,
    then the augmentations' draws (augmentations.draw_augmentations)."""
    weights = scalars[:len(losses)]
    draws = scalars[len(losses):].reshape(-1, batch['y'].shape[0])
    batch = augmentations_lib.apply_drawn(augmentations, draws, batch)
    if data_parallel:
      start, size = distributed.process_batch_slice(batch['y'].shape[0])
      batch = {k: v[start:start + size] for k, v in batch.items()}
    predictions = model(batch['x0'], batch['x1'], batch['time'])
    per_loss = {}
    total = torch.zeros((), dtype=torch.float32, device=batch['y'].device)
    for (name, (loss_fn, _)), weight in zip(losses.items(), weights):
      value = loss_fn(batch, predictions)
      per_loss[name] = value.detach()
      total = total + weight * value
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    if data_parallel:
      total = _average_over_ranks(model, per_loss, total)
    optimizer.step()
    metrics = dict(per_loss)
    metrics['training_loss'] = total.detach()
    if not with_summaries:
      return metrics, {}
    # Image-shaped step outputs for TensorBoard, the reference's
    # image_summaries selection (train_lib.py:72-93).
    summaries = {'x0': batch['x0'], 'x1': batch['x1'], 'y': batch['y'],
                 'pred_y': predictions['image'].detach()}
    for key in _EXTRA_IMAGE_SUMMARIES:
      value = predictions.get(key)
      if isinstance(value, torch.Tensor) and value.dim() == 4:
        summaries[key] = value.detach()
    return metrics, summaries

  def program_of(model: FilmNet, optimizer: torch.optim.Optimizer):
    key = (id(model), id(optimizer))
    if key not in bound:
      for old in bound.values():
        if old is not None:
          old.release()
      bound.clear()
      device = next(model.parameters()).device
      program = None
      if _captured(graphs, device, data_parallel):
        if not all(group.get('capturable') and
                   isinstance(group['lr'], torch.Tensor)
                   for group in optimizer.param_groups):
          raise ValueError('make_train_step: a captured step needs a '
                           'capturable optimizer with a device learning '
                           'rate (create_optimizer on the CUDA device)')
        program = programs.Program(
            lambda batch, scalars: body(model, optimizer, batch, scalars),
            device, 'summary_step' if with_summaries else 'train_step',
            pool=pool)
      bound[key] = program
    return bound[key]

  def step_fn(state: TrainState, batch: Batch, generator: torch.Generator):
    model, optimizer = state.model, state.optimizer
    program = program_of(model, optimizer)
    draws = augmentations_lib.draw_augmentations(
        augmentations, generator, batch['y'].shape[0])
    weights = torch.tensor([weight_fn(state.step)
                            for _, weight_fn in losses.values()],
                           dtype=torch.float32, device=draws.device)
    scalars = torch.cat([weights, draws.reshape(-1)])
    device = batch['y'].device
    if scalars.device.type == 'cpu' and device.type == 'cuda':
      scalars = scalars.pin_memory()
    set_learning_rate(optimizer, schedule(state.step))
    if program is not None:
      outputs = program(batch, scalars)
    else:
      outputs = body(model, optimizer, batch,
                     scalars.to(device, non_blocking=True))
    state.step += 1
    return outputs

  step_fn.programs = lambda: [p for p in bound.values() if p is not None]
  return step_fn


def _captured(graphs: Optional[bool], device: torch.device,
              data_parallel: bool) -> bool:
  """Whether a step runs as a captured program (see make_train_step)."""
  backend = distributed.backend() if data_parallel else None
  if backend not in (None, 'nccl'):
    if graphs:
      raise ValueError(f'make_train_step: graphs=True takes no data-parallel '
                       f'step over {backend}: its all-reduce runs through '
                       f'the host, which a CUDA graph cannot hold (NCCL\'s '
                       f'can be captured)')
    return False
  return programs.resolve(graphs, device, 'make_train_step')


def _average_over_ranks(model: FilmNet, per_loss: Dict[str, torch.Tensor],
                        total: torch.Tensor) -> torch.Tensor:
  """Replaces every gradient and every entry of `per_loss` by its mean over
  the ranks (one all-reduce); returns the mean training loss. The
  gradients are written in place, where a captured step's optimizer reads
  them."""
  params = list(model.parameters())
  grads = [torch.zeros_like(p) if p.grad is None else p.grad
           for p in params]
  losses = torch.stack([*per_loss.values(), total.detach()])
  *grads, losses = distributed.all_reduce_mean(grads + [losses])
  for p, g in zip(params, grads):
    if p.grad is None:
      p.grad = g
    else:
      p.grad.copy_(g)
  for i, name in enumerate(per_loss):
    per_loss[name] = losses[i]
  return losses[-1]


# ---- checkpointing ----------------------------------------------------------


class CheckpointManager:
  """Saves and restores the latest train state, keeping `max_to_keep`.

  Checkpoints live under `<run>/train`, as the reference's
  tf.train.CheckpointManager keeps them (train_lib.py:202-206): one
  `ckpt-<step>.pt` per save, `torch.save` of the step, the model's
  state_dict and the optimizer's. `create=False` only reads: the
  directory is not made (a rank other than 0 restores, rank 0 saves).
  """

  _NAME = re.compile(r'^ckpt-(\d+)\.pt$')

  def __init__(self, directory: str, max_to_keep: int = 10,
               create: bool = True):
    self._directory = os.path.abspath(directory)
    self._max_to_keep = max_to_keep
    if create:
      os.makedirs(self._directory, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self._directory, f'ckpt-{step}.pt')

  def steps(self) -> Sequence[int]:
    if not os.path.isdir(self._directory):
      return []
    found = (self._NAME.match(name) for name in os.listdir(self._directory))
    return sorted(int(m.group(1)) for m in found if m)

  def latest_step(self) -> Optional[int]:
    steps = self.steps()
    return steps[-1] if steps else None

  def save(self, state: TrainState) -> None:
    path = self._path(state.step)
    partial = f'{path}.{os.getpid()}.tmp'
    torch.save({'step': state.step,
                'model': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict()}, partial)
    os.replace(partial, path)
    for step in self.steps()[:-self._max_to_keep]:
      os.remove(self._path(step))

  def restore(self, state: TrainState) -> bool:
    """Loads the latest checkpoint into `state`; False if there is none."""
    step = self.latest_step()
    if step is None:
      return False
    device = next(state.model.parameters()).device
    payload = torch.load(self._path(step), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload['model'])
    state.optimizer.load_state_dict(payload['optimizer'])
    device_form(state.optimizer)
    state.step = int(payload['step'])
    return True


# ---- the loop ---------------------------------------------------------------


def batch_to_device(batch: Mapping[str, Any], device: torch.device) -> Batch:
  """A host batch of numpy arrays as f32 tensors on `device` (list-valued
  entries, such as eval paths, are dropped)."""
  return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
          for k, v in batch.items() if not isinstance(v, list)}


def step_generator(seed: int, step: int) -> torch.Generator:
  """The augmentation generator of one step: a function of (seed, step)
  alone, so a resumed run draws what an uninterrupted one would."""
  return torch.Generator().manual_seed(seed * 2**32 + step)


def train_loop(
    state: TrainState,
    losses: Losses,
    train_iterator: Iterator[Dict[str, np.ndarray]],
    opts: TrainingOptions,
    run_dir: str,
    augmentation_names: Sequence[str] = (),
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    eval_fn: Optional[Callable[[TrainState, int], None]] = None,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    graphs: Optional[bool] = None,
) -> TrainState:
  """Runs training to `opts.num_steps`, resuming from the run dir if set.

  Layout parity with the reference run dir (README.md:186-195):
  `<run_dir>/train` holds the summaries and the checkpoints. `eval_fn`, if
  given, runs after each checkpoint with the state and its step. With
  `profile_dir`, the steps from `profile_start_step` (counted in updates
  made, as state.step is) for `profile_num_steps` are traced there.

  In a process group every rank runs the loop on the same global batches
  (data-parallel, see the module docstring); only rank 0 logs, traces and
  writes anything under `run_dir`. `graphs` is `make_train_step`'s for
  both variants, the lean steps and the logging (summary) steps, whose
  programs share one memory pool.
  """
  data_parallel = distributed.is_initialized()
  lead = distributed.rank() == 0
  if not lead:
    log_fn = _silent
  device = next(state.model.parameters()).device
  pool = programs.Pool() if device.type == 'cuda' else None
  step_fn, summary_step_fn = (
      make_train_step(losses, opts, augmentation_names,
                      with_summaries=summaries, data_parallel=data_parallel,
                      graphs=graphs, pool=pool)
      for summaries in (False, True))
  ckpt = CheckpointManager(os.path.join(run_dir, 'train'),
                           max_to_keep=opts.max_to_keep, create=lead)
  if ckpt.restore(state):
    log_fn(f'Restored checkpoint at step {state.step}')
  state.model.train()
  schedule = learning_rate_schedule(opts)

  writer = tensorboard.create_writer(
      os.path.join(run_dir, 'train') if lead else None)
  timer = profiling.StepTimer(opts.timing_interval, start_step=state.step,
                              device=device)
  trace = None
  try:
    while state.step < opts.num_steps:
      if profile_dir and lead and state.step == profile_start_step:
        trace = profiling.Trace(profile_dir)
      batch = batch_to_device(next(train_iterator), device)
      next_step = state.step + 1
      will_log = (next_step % opts.save_interval == 0 or
                  next_step == opts.num_steps)
      # A replayed step calls nothing in Python that a trace would name
      # (Adam's own annotation among them): the window marks each step.
      with torch.profiler.record_function('train_step'):
        metrics, summaries = (summary_step_fn if will_log else step_fn)(
            state, batch, step_generator(seed, state.step))
      if trace is not None and (
          next_step >= profile_start_step + profile_num_steps):
        _close_trace(trace, profile_start_step, next_step, log_fn)
        trace = None

      steps_per_sec = timer.update(next_step)
      if steps_per_sec is not None:
        writer.scalar('steps/sec', steps_per_sec, next_step)

      if will_log and lead:
        host_metrics = {k: float(v) for k, v in metrics.items()}
        for name, value in host_metrics.items():
          writer.scalar(f'losses/{name}', value, next_step)
        writer.scalar('learning_rate', schedule(next_step), next_step)
        # Clipped image + histogram of every image-shaped step output, the
        # reference's _summary_writer behavior (train_lib.py:103-111).
        for name, value in summaries.items():
          images = value.float().cpu().numpy()
          writer.image(f'training/{name}', np.clip(images[0], 0.0, 1.0),
                       next_step)
          writer.histogram(f'training/{name}_h', images, next_step)
        ckpt.save(state)
        log_fn(f'step {next_step}: ' + ', '.join(
            f'{k}={v:.5f}' for k, v in host_metrics.items()))
        if eval_fn is not None:
          eval_fn(state, next_step)
        writer.flush()
      if will_log:
        distributed.barrier()  # every rank waits for rank 0's save
  finally:
    # A run that ends or fails inside the window closes it there.
    if trace is not None:
      _close_trace(trace, profile_start_step, state.step, log_fn)
  writer.close()
  return state


def _silent(message: str) -> None:
  del message


def _close_trace(trace: profiling.Trace, first: int, end: int,
                 log_fn: Callable[[str], None]) -> None:
  path = trace.stop(f'steps_{first}_{end}')
  log_fn(f'Wrote profiler trace for steps [{first}, {end}) to {path}')


def train(model: FilmNet,
          model_options: Options,
          losses: Losses,
          train_iterator: Iterator[Dict[str, np.ndarray]],
          opts: TrainingOptions,
          run_dir: str,
          init_generator: Optional[torch.Generator] = None,
          device: Any = 'cuda',
          augmentation_names: Sequence[str] = (),
          seed: int = 0,
          log_fn: Callable[[str], None] = print,
          eval_fn: Optional[Callable[[TrainState, int], None]] = None,
          profile_dir: Optional[str] = None,
          profile_start_step: int = 10,
          profile_num_steps: int = 5,
          graphs: Optional[bool] = None,
          ) -> TrainState:
  """End to end: init (or restore), run the loop, export the weights.

  The weights are drawn on the CPU from `init_generator` (seed 0 when
  None), then the model moves to `device`. The trained weights go to
  `<run_dir>/saved_model` (io/params_io.save_state_bundle), which the
  port's Interpolator loads. In a process group each rank passes its own
  device (parallel/distributed.rank_device); every rank draws the same
  weights, and rank 0 alone writes. `graphs` as `train_loop`'s.
  """
  if init_generator is None:
    init_generator = torch.Generator().manual_seed(0)
  model = init_params(model, init_generator).to(device)
  state = create_train_state(model, opts)
  lead = distributed.rank() == 0
  # The model's hyperparameters beside its checkpoints, so that a
  # checkpoint converts into a bundle (cli/build_params) on its own.
  if lead:
    params_io.write_options(os.path.join(run_dir, 'train'), model_options)
  state = train_loop(state, losses, train_iterator, opts, run_dir,
                     augmentation_names=augmentation_names, seed=seed,
                     log_fn=log_fn, eval_fn=eval_fn, profile_dir=profile_dir,
                     profile_start_step=profile_start_step,
                     profile_num_steps=profile_num_steps, graphs=graphs)
  if lead:
    bundle_dir = os.path.join(run_dir, 'saved_model')
    params_io.save_state_bundle(bundle_dir, state.model.state_dict(),
                                model_options)
    log_fn(f'Exported the trained weights to {bundle_dir}')
  distributed.barrier()
  return state
