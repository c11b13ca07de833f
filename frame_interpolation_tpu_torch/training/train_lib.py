"""The training loop of the film_net interpolator (PyTorch, one device).

Port of frame_interpolation_tpu/training/train_lib.py (itself the
reference's training/train.py and train_lib.py):

  * Adam with staircase exponential learning-rate decay (train.py:99-104);
    the update with index n (from 0) uses schedule(n), as optax counts;
  * a weighted multi-loss objective whose weights depend on the step
    (train_lib.py:46-60);
  * checkpoint save and restore-and-resume every `save_interval` steps,
    keeping `max_to_keep` (train_lib.py:194-210, 243-244);
  * TensorBoard scalars, images and histograms, and steps/sec
    (train_lib.py:212-214, 254-269);
  * an export of the trained weights at the end (train_lib.py:276-280), as
    the port's state bundle (io/params_io.save_state_bundle);
  * an `eval_fn(state, step)` hook at each save interval, which the train
    CLI fills with training/eval_lib.eval_loop (train_lib.py:313-314).

The model, the batch and the augmentations live on one device; on CUDA the
warp and the extractor's conv stacks run the hand-written kernels forward
and backward (ops/warp.py, ops/conv_stack.py). The multi-host path and the
perceptual losses wait for later slices (ROADMAP A8, A10).
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import losses as losses_lib
from ..data import augmentations as augmentations_lib
from ..io import params_io
from ..models.film_net import FilmNet, init_params
from ..options import Options
from ..utils import tensorboard


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
  `learning_rate_schedule` (see `make_train_step`).
  """
  return torch.optim.Adam(parameters, lr=learning_rate_schedule(opts)(0),
                          eps=1e-7)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
  for group in optimizer.param_groups:
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
  which keeps no images: `summaries` is then empty.
  """
  augmentation_fns = augmentations_lib.data_augmentations(augmentation_names)
  schedule = learning_rate_schedule(opts)

  def step_fn(state: TrainState, batch: Batch, generator: torch.Generator):
    batch = augmentations_lib.apply_data_augmentation(
        augmentation_fns, generator, batch)
    model, optimizer = state.model, state.optimizer
    predictions = model(batch['x0'], batch['x1'], batch['time'])
    per_loss = {}
    total = torch.zeros((), dtype=torch.float32, device=batch['y'].device)
    for name, (loss_fn, weight_fn) in losses.items():
      value = loss_fn(batch, predictions)
      per_loss[name] = value.detach()
      total = total + weight_fn(state.step) * value
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    set_learning_rate(optimizer, schedule(state.step))
    optimizer.step()
    state.step += 1
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

  return step_fn


# ---- checkpointing ----------------------------------------------------------


class CheckpointManager:
  """Saves and restores the latest train state, keeping `max_to_keep`.

  Checkpoints live under `<run>/train`, as the reference's
  tf.train.CheckpointManager keeps them (train_lib.py:202-206): one
  `ckpt-<step>.pt` per save, `torch.save` of the step, the model's
  state_dict and the optimizer's.
  """

  _NAME = re.compile(r'^ckpt-(\d+)\.pt$')

  def __init__(self, directory: str, max_to_keep: int = 10):
    self._directory = os.path.abspath(directory)
    self._max_to_keep = max_to_keep
    os.makedirs(self._directory, exist_ok=True)

  def _path(self, step: int) -> str:
    return os.path.join(self._directory, f'ckpt-{step}.pt')

  def steps(self) -> Sequence[int]:
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
) -> TrainState:
  """Runs training to `opts.num_steps`, resuming from the run dir if set.

  Layout parity with the reference run dir (README.md:186-195):
  `<run_dir>/train` holds the summaries and the checkpoints. `eval_fn`, if
  given, runs after each checkpoint with the state and its step.
  """
  step_fn = make_train_step(losses, opts, augmentation_names,
                            with_summaries=False)
  summary_step_fn = make_train_step(losses, opts, augmentation_names,
                                    with_summaries=True)
  ckpt = CheckpointManager(os.path.join(run_dir, 'train'),
                           max_to_keep=opts.max_to_keep)
  if ckpt.restore(state):
    log_fn(f'Restored checkpoint at step {state.step}')
  device = next(state.model.parameters()).device
  state.model.train()
  schedule = learning_rate_schedule(opts)

  writer = tensorboard.create_writer(os.path.join(run_dir, 'train'))
  timing_start = time.monotonic()
  timing_step = state.step
  while state.step < opts.num_steps:
    batch = batch_to_device(next(train_iterator), device)
    next_step = state.step + 1
    will_log = (next_step % opts.save_interval == 0 or
                next_step == opts.num_steps)
    metrics, summaries = (summary_step_fn if will_log else step_fn)(
        state, batch, step_generator(seed, state.step))

    if next_step % opts.timing_interval == 0:
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      now = time.monotonic()
      steps_per_sec = (next_step - timing_step) / max(now - timing_start,
                                                      1e-9)
      writer.scalar('steps/sec', steps_per_sec, next_step)
      timing_start, timing_step = now, next_step

    if will_log:
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

  writer.close()
  return state


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
          eval_fn: Optional[Callable[[TrainState, int], None]] = None
          ) -> TrainState:
  """End to end: init (or restore), run the loop, export the weights.

  The weights are drawn on the CPU from `init_generator` (seed 0 when
  None), then the model moves to `device`. The trained weights go to
  `<run_dir>/saved_model` (io/params_io.save_state_bundle), which the
  port's Interpolator loads.
  """
  if init_generator is None:
    init_generator = torch.Generator().manual_seed(0)
  model = init_params(model, init_generator).to(device)
  state = create_train_state(model, opts)
  state = train_loop(state, losses, train_iterator, opts, run_dir,
                     augmentation_names=augmentation_names, seed=seed,
                     log_fn=log_fn, eval_fn=eval_fn)
  bundle_dir = os.path.join(run_dir, 'saved_model')
  params_io.save_state_bundle(bundle_dir, state.model.state_dict(),
                              model_options)
  log_fn(f'Exported the trained weights to {bundle_dir}')
  return state
