"""Training steps: the port's lean train step (`make_train_step(...,
with_summaries=False)`, captured on the card), fed as `train_loop` feeds
it.

Traffic: `pool` host batches of `batch` float32 triplets of `crop` x
`crop` (traffic/frames.py, motions up to `max_motion_px`), each through
`train_lib.batch_to_device` before its step; step n draws its
augmentations from a generator seeded by (seed, n). The configuration
gives the losses with their gin schedules, the augmentations, Adam's
learning rate and the precision switches.

Set-up builds one training state and runs its first `checked_steps`
steps (the step's warm-up and capture, then replays) on the pool's first
batches, all different; the window continues the same state from there.
Correct: the reference (reference/training.py, float32) follows those
first steps from the same weights, batches and draws, with every conv in
cuDNN's TF32 on channels_last tensors where the configuration lets cuDNN
take TF32 on the card (reference/tf32_convs.py), as the program's convs
run there, and in exact float32 elsewhere. Compared, each by its median
leaf where it is a leaf norm: the first step's losses and gradient norms
(the program's gradient read from Adam's first moment after the step),
the norms of the parameters' change over the steps, and each later step
(a graph replay) on its own: its losses, and the first replay's gradient
norms (the program's from the change of Adam's first moment), against
the reference's step from the parameters the program held before it.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import weights
from ..reference import film_net as ref
from ..reference import lowp
from ..reference import tf32_convs
from ..reference import training as ref_training
from ..traffic import frames as traffic
from . import common

# Loss names as the port's metrics carry them (a scheduled weight is
# shown as k*<name>).
_METRIC_KEYS = {'l1': 'l1', 'vgg': 'k*vgg', 'style': 'k*style',
                'total': 'training_loss'}


def step_generator(seed: int, step: int) -> torch.Generator:
  return torch.Generator().manual_seed(traffic.derived_seed(seed, 'step',
                                                            step))


def loss_weights(config: dict, step: int) -> Dict[str, float]:
  """Each loss's weight at `step`: the gin's piecewise-constant schedules
  (values[i] on (boundaries[i-1], boundaries[i]])."""
  out = {}
  for name, schedule in config['losses'].items():
    value = schedule['values'][0]
    for boundary, v in zip(schedule['boundaries'], schedule['values'][1:]):
      if step > boundary:
        value = v
    out[name] = float(np.float32(value))
  return out


class Driver:

  def __init__(self, ctx):
    self.ctx = ctx
    self.traffic = ctx.workload['traffic']
    self.options = common.options_dict(ctx.config)
    self.checked = int(self.traffic['checked_steps'])
    self.vgg_dir = tempfile.TemporaryDirectory(prefix='film_bench_vgg_')

  def _losses(self, vgg_file: str):
    from frame_interpolation_tpu_torch import losses as losses_lib
    schedules = [losses_lib.PiecewiseConstantSchedule(
        tuple(s['boundaries']), tuple(s['values']))
                 for s in self.ctx.config['losses'].values()]
    return losses_lib.training_losses(list(self.ctx.config['losses']),
                                      loss_weight_schedules=schedules,
                                      vgg_model_file=vgg_file)

  def setup(self) -> None:
    from frame_interpolation_tpu_torch.training import train_lib
    ctx, t, cfg = self.ctx, self.traffic, self.ctx.config
    torch.backends.cudnn.allow_tf32 = bool(cfg['cudnn_allow_tf32'])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg['matmul_allow_tf32'])
    self.vgg = weights.vgg19(ctx.seed)
    vgg_file = os.path.join(self.vgg_dir.name, 'vgg19.mat')
    weights.write_vgg_mat(vgg_file, self.vgg)
    net, _ = common.model(ctx)
    opts = train_lib.TrainingOptions(learning_rate=float(cfg['learning_rate']))
    self.lr = float(cfg['learning_rate'])
    self.state = train_lib.create_train_state(net, opts)
    self.step_fn = train_lib.make_train_step(
        self._losses(vgg_file), opts, tuple(cfg['augmentations']),
        with_summaries=False)
    self.to_device = train_lib.batch_to_device
    self.pool = traffic.triplet_batches(
        ctx.seed, int(t['pool']), int(t['batch']), int(t['crop']),
        float(t['max_motion_px']), ctx.device)
    # The first steps: every shape's warm-up and capture, and what the
    # reference follows; the state each later step starts from, and the
    # gradient it gave Adam (m' = b1 m + (1 - b1) g).
    self.program_losses: List[Dict[str, float]] = []
    self.program_states: List[Dict[str, torch.Tensor]] = []
    self.program_step_grads: List[Dict[str, float]] = []
    named = dict(net.named_parameters())
    beta1 = self.state.optimizer.param_groups[0]['betas'][0]
    moments = self.state.optimizer.state
    held = {k: torch.zeros(p.shape, dtype=torch.float64)
            for k, p in named.items()}
    for n in range(self.checked):
      if n:
        self.program_states.append({k: p.detach().to('cpu', copy=True)
                                    for k, p in named.items()})
      metrics, _ = self._step(n)
      self.program_losses.append({k: float(metrics[v])
                                  for k, v in _METRIC_KEYS.items()})
      now = {k: moments[p]['exp_avg'].cpu().double()
             if 'exp_avg' in moments[p] else torch.zeros(
                 p.shape, dtype=torch.float64) for k, p in named.items()}
      grads = {k: (now[k] - beta1 * held[k]) / (1 - beta1) for k in now}
      self.program_step_grads.append(ref_training.leaf_norms(grads))
      if n == 0:
        self.program_grad_tensors = {k: v.float() for k, v in grads.items()}
      held = now
    del held, now, grads
    self.program_grads = self.program_step_grads[0]
    start = weights.film_net(ref.parameter_shapes(self.options), ctx.seed,
                             ctx.device)
    self.program_change = {k: float((p.detach() - start[k]).double().norm())
                           for k, p in named.items()}
    self.program_params = {k: p.detach().to('cpu', copy=True)
                           for k, p in named.items()}
    del start
    common.sync(ctx.device)

  def _step(self, n: int):
    batch = self.to_device(self.pool[n % len(self.pool)], self.ctx.device)
    return self.step_fn(self.state, batch, step_generator(self.ctx.seed, n))

  def window(self) -> dict:
    ctx = self.ctx
    start = ctx.open_window()
    n, failed = self.checked, 0
    while time.perf_counter() - start < ctx.seconds:
      with ctx.span('step'):
        self._step(n)
      n += 1
      ctx.tick(1)
    common.sync(ctx.device)
    seconds = time.perf_counter() - start
    steps = n - self.checked
    return {'attempted': steps, 'failed': failed,
            'metrics': {'train_steps_per_s': steps / seconds}}

  def release(self) -> None:
    for program in self.step_fn.programs():
      program.release()
    del self.state, self.step_fn

  def _inputs(self):
    """The checked steps' batches on the device, fresh generators and
    loss weights."""
    ctx = self.ctx
    batches = [{k: torch.from_numpy(v).to(ctx.device)
                for k, v in self.pool[n].items()}
               for n in range(self.checked)]
    generators = [step_generator(ctx.seed, n) for n in range(self.checked)]
    return batches, generators, [loss_weights(ctx.config, n)
                                 for n in range(self.checked)]

  def reference(self, quant=None, keep=None, keep_from=0,
                states=False) -> dict:
    ctx = self.ctx
    _exact_f32()
    params = weights.film_net(ref.parameter_shapes(self.options), ctx.seed,
                              ctx.device)
    vgg = weights.vgg19_tensors(self.vgg, ctx.device)
    with self._convs(quant):
      return ref_training.run(
          params, self.options, *self._inputs(), self.lr, vgg,
          lowp.QUANT[quant] if quant else None, keep, keep_from, states)

  def follow(self, states) -> list:
    """The reference's later steps, each from the parameters that the run
    judged held before it."""
    _exact_f32()
    vgg = weights.vgg19_tensors(self.vgg, self.ctx.device)
    with self._convs(None):
      return ref_training.follow(states, self.options, *self._inputs(), vgg,
                                 self.ctx.device)

  def _convs(self, quant):
    """The reference's convs at the configuration's precision: cuDNN's
    TF32 where it lets cuDNN take TF32 and the run is on the card (a CPU's
    convs take float32 whatever the switch says); the control's `quant`
    rounds them itself."""
    if (quant is None and self.ctx.config['cudnn_allow_tf32'] and
        torch.device(self.ctx.device).type == 'cuda'):
      return tf32_convs.TF32Convs()
    return contextlib.nullcontext()

  def check(self, quant=None, fault=None) -> list:
    """[(name, reading, limit)]. With `quant`, the reference at that
    precision stands in the program's place (the control); with fault
    'half_batch', the reference on each batch's first half, and with
    'half_batch_replays' so from the second step on."""
    want = self.reference()
    half = int(self.traffic['batch']) // 2
    if fault == 'half_batch':
      got = self.reference(keep=half, states=True)
    elif fault == 'half_batch_replays':
      got = self.reference(keep=half, keep_from=1, states=True)
    elif quant is None:
      got = {'losses': self.program_losses, 'grad_norms': self.program_grads,
             'step_grad_norms': self.program_step_grads,
             'change_norms': self.program_change,
             'grads': self.program_grad_tensors, 'params': self.program_params,
             'states': self.program_states}
    else:
      got = self.reference(quant, states=True)
    self.readings = readings(got, want, self.follow(got['states']))
    return [(k, self.readings[k], float(v))
            for k, v in self.ctx.workload['limits'].items()]


def _exact_f32() -> None:
  """The reference's switches: TF32 off (`_convs` turns it on where the
  configuration's convs take it)."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False


def readings(got: dict, want: dict, followed: list) -> dict:
  """Every number the comparison reads, by name; the workload's limits
  say which are compared. `followed`: the reference's steps 1.. from the
  parameters `got` held before each."""

  def loss_gap(g, w):
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
               for k in ('l1', 'vgg', 'style', 'total'))

  def median(gaps):
    values = sorted(gaps.values())
    return values[len(values) // 2]

  grad, grad_leaf = ref_training.norm_gap(got['grad_norms'],
                                          want['grad_norms'])
  change, change_leaf = ref_training.norm_gap(
      got['change_norms'], want['change_norms'], rule=want['grad_norms'])

  kept = ref_training.leaf_gaps(got['grad_norms'], want['grad_norms'])
  grad_diff = ref_training.diff_norms(got['grads'], want['grads'], kept)
  param_diff = ref_training.diff_norms(got['params'], want['params'], kept)

  later = range(1, len(want['losses']))
  first = {f'first_{k}_gap': abs(got['losses'][0][k] - want['losses'][0][k]) /
           max(abs(want['losses'][0][k]), 1e-12)
           for k in ('l1', 'vgg', 'style', 'total')}
  replays = [(loss_gap(got['losses'][i], f['losses']),
              median(ref_training.leaf_gaps(got['step_grad_norms'][i],
                                            f['grad_norms'])))
             for i, f in zip(later, followed)]
  # Each replay's median-leaf gradient gap by itself: the first is
  # compared; later ones carry the later steps' noise (PERF.md).
  replay_grads = {f'replay{i}_grad_norm_gap_median': r[1]
                  for i, r in enumerate(replays, start=1)}
  return {**first,
          'first_loss_gap': loss_gap(got['losses'][0], want['losses'][0]),
          'later_loss_gap': max((loss_gap(got['losses'][i], want['losses'][i])
                                 for i in later), default=0.0),
          'replay_loss_gap': max((r[0] for r in replays), default=0.0),
          **replay_grads,
          'grad_norm_gap': grad, 'change_norm_gap': change,
          'grad_norm_gap_median': median(ref_training.leaf_gaps(
              got['grad_norms'], want['grad_norms'])),
          'change_norm_gap_median': median(ref_training.leaf_gaps(
              got['change_norms'], want['change_norms'],
              rule=want['grad_norms'])),
          'grad_diff_median': median(grad_diff),
          'grad_diff_worst': max(grad_diff.values()),
          'param_diff_median': median(param_diff),
          'param_diff_worst': max(param_diff.values()),
          'grad_leaf': grad_leaf, 'change_leaf': change_leaf}
