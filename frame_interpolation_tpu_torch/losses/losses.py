"""Training and evaluation losses for the film_net interpolator (PyTorch).

Port of frame_interpolation_tpu/losses/losses.py (itself the reference's
losses/losses.py): every loss takes (example, prediction) dicts, where
`example['y']` is the ground-truth middle frame and `prediction['image']`
the model output, and returns a scalar tensor. Training combines several
losses with weights that depend on the step.

The perceptual losses ('vgg', 'style', losses/vgg19.py) need the
MatConvNet VGG-19 weights (imagenet-vgg-verydeep-19.mat): `get_loss` raises
ValueError without `vgg_model_file`, as the JAX package's does, and
FileNotFoundError when the file is missing.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import image_metrics
from . import vgg19

LossFn = Callable[[Mapping[str, Any], Mapping[str, Any]], torch.Tensor]
WeightFn = Callable[[Any], float]


@dataclasses.dataclass(frozen=True)
class PiecewiseConstantSchedule:
  """tf.keras PiecewiseConstantDecay parity: values[i] on (b[i-1], b[i]]."""
  boundaries: Tuple[float, ...]
  values: Tuple[float, ...]

  def __post_init__(self):
    if len(self.values) != len(self.boundaries) + 1:
      raise ValueError('need len(values) == len(boundaries) + 1')

  def __call__(self, step) -> float:
    # f32, as the JAX schedule computes it.
    step = np.float32(step)
    result = np.float32(self.values[0])
    for boundary, value in zip(self.boundaries, self.values[1:]):
      if step > boundary:
        result = np.float32(value)
    return float(result)

  @property
  def is_constant_one(self) -> bool:
    return set(self.values) == {1.0}


def constant_schedule(value: float) -> PiecewiseConstantSchedule:
  return PiecewiseConstantSchedule(boundaries=(0,), values=(value, value))


# ---- individual losses ------------------------------------------------------


def l1_loss(example, prediction) -> torch.Tensor:
  return (prediction['image'] - example['y']).abs().mean()


def l2_loss(example, prediction) -> torch.Tensor:
  return (prediction['image'] - example['y']).square().mean()


def l1_warped_loss(example, prediction) -> torch.Tensor:
  """L1 on the aux warped frames against ground truth."""
  loss = torch.zeros((), dtype=torch.float32, device=example['y'].device)
  for key in ('x0_warped', 'x1_warped'):
    if key in prediction:
      loss = loss + (prediction[key] - example['y']).abs().mean()
  return loss


def ssim_loss(example, prediction) -> torch.Tensor:
  return image_metrics.ssim(prediction['image'], example['y'],
                            max_val=1.0).mean()


def psnr_loss(example, prediction) -> torch.Tensor:
  return image_metrics.psnr(prediction['image'], example['y'],
                            max_val=1.0).mean()


def make_vgg_loss(vgg_model_file: str,
                  weights: Optional[Sequence[float]] = None) -> LossFn:
  def fn(example, prediction):
    return vgg19.vgg_loss(prediction['image'], example['y'], vgg_model_file,
                          weights)
  return fn


def make_style_loss(vgg_model_file: str,
                    weights: Optional[Sequence[float]] = None) -> LossFn:
  def fn(example, prediction):
    return vgg19.style_loss(prediction['image'], example['y'],
                            vgg_model_file, weights)
  return fn


# ---- registry and factories -------------------------------------------------

_SIMPLE: Dict[str, LossFn] = {
    'l1': l1_loss,
    'l2': l2_loss,
    'ssim': ssim_loss,
    'psnr': psnr_loss,
    'l1_warped': l1_warped_loss,
}


def get_loss(loss_name: str,
             vgg_model_file: Optional[str] = None) -> LossFn:
  """Name -> loss fn registry (reference losses.py:116-133)."""
  if loss_name in _SIMPLE:
    return _SIMPLE[loss_name]
  if loss_name in ('vgg', 'style'):
    if not vgg_model_file:
      raise ValueError(f'loss {loss_name!r} needs vgg_model_file')
    # Checked here, not at the first step that reads it.
    if not os.path.isfile(vgg_model_file):
      raise FileNotFoundError(f'loss {loss_name!r}: no VGG-19 weights at '
                              f'{vgg_model_file}')
    make = make_vgg_loss if loss_name == 'vgg' else make_style_loss
    return make(vgg_model_file)
  raise ValueError(f'Invalid loss function {loss_name}')


@dataclasses.dataclass(frozen=True)
class LossConfig:
  """One weighted loss: a name plus a step-dependent weight schedule."""
  name: str
  weight_schedule: PiecewiseConstantSchedule = dataclasses.field(
      default_factory=lambda: constant_schedule(1.0))


def create_losses(configs: Sequence[LossConfig],
                  vgg_model_file: Optional[str] = None
                  ) -> Dict[str, Tuple[LossFn, WeightFn]]:
  """Builds {display_name: (loss_fn, weight_fn)}.

  Constant-1.0 weights keep the bare name; scheduled weights get the 'k*'
  prefix, the reference's TensorBoard naming (losses/losses.py:166-176).
  """
  losses = {}
  for config in configs:
    schedule = config.weight_schedule
    display = config.name if schedule.is_constant_one else f'k*{config.name}'
    losses[display] = (get_loss(config.name, vgg_model_file), schedule)
  return losses


def training_losses(loss_names: Sequence[str],
                    loss_weights: Optional[Sequence[float]] = None,
                    loss_weight_schedules: Optional[
                        Sequence[PiecewiseConstantSchedule]] = None,
                    vgg_model_file: Optional[str] = None
                    ) -> Dict[str, Tuple[LossFn, WeightFn]]:
  """Reference training_losses factory (losses/losses.py:181-209)."""
  if loss_weights is not None:
    configs = [LossConfig(n, constant_schedule(w))
               for n, w in zip(loss_names, loss_weights)]
  elif loss_weight_schedules is not None:
    configs = [LossConfig(n, s)
               for n, s in zip(loss_names, loss_weight_schedules)]
  else:
    configs = [LossConfig(n) for n in loss_names]
  return create_losses(configs, vgg_model_file)


# Same semantics; the separate name mirrors the reference's gin scoping.
test_losses = training_losses


def aggregate_batch_losses(
    batch_losses: List[Mapping[str, float]]) -> Dict[str, float]:
  """Averages a list of per-batch loss dicts (losses/losses.py:241-266)."""
  transposed: Dict[str, List[float]] = {}
  for batch in batch_losses:
    for name, value in batch.items():
      transposed.setdefault(name, []).append(float(value))
  return {name: float(np.mean(values))
          for name, values in transposed.items()}


def compute_weighted_loss(losses: Mapping[str, Tuple[LossFn, WeightFn]],
                          example, prediction, step) -> torch.Tensor:
  """Sum of weight(step) * loss(example, prediction) over all losses; the
  perceptual losses share each image's VGG-19 tower
  (vgg19.shared_features)."""
  total = torch.zeros((), dtype=torch.float32,
                      device=prediction['image'].device)
  with vgg19.shared_features():
    for loss_fn, weight_fn in losses.values():
      total = total + weight_fn(step) * loss_fn(example, prediction)
  return total
