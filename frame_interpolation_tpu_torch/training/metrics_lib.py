"""Evaluation metrics, as functions of (example, prediction, step).

Port of frame_interpolation_tpu/training/metrics_lib.py (the reference's
dict-based Keras metrics, training/metrics_lib.py):

  * 'l1': plain L1 (L1Metric, :58-81);
  * 'training_loss': the whole weighted training objective on eval data,
    the reference's overfitting probe (TrainLossMetric, :23-55);
  * one metric per configured test loss, its weight applied
    (GenericLossMetric, :84-119).

Each returns a scalar tensor; the eval loop averages them on the host
(losses.aggregate_batch_losses).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from .. import losses as losses_lib

MetricFn = Callable[[Mapping, Mapping, int], torch.Tensor]


def create_metrics_fns(
    test_losses: Mapping[str, Tuple[losses_lib.LossFn, losses_lib.WeightFn]],
    training_losses: Mapping[str, Tuple[losses_lib.LossFn,
                                        losses_lib.WeightFn]],
) -> Dict[str, MetricFn]:
  """The metric dict (reference create_metrics_fn, :122-142).

  Each metric is fn(example, prediction, step) -> scalar; `step` feeds the
  weight schedules (the training loss's weights change with the step).
  """
  metrics: Dict[str, MetricFn] = {}

  metrics['l1'] = lambda example, prediction, step: losses_lib.l1_loss(
      example, prediction)

  def training_loss_metric(example, prediction, step):
    return losses_lib.compute_weighted_loss(training_losses, example,
                                            prediction, step)

  metrics['training_loss'] = training_loss_metric

  for name, (loss_fn, weight_fn) in test_losses.items():

    def generic(example, prediction, step, loss_fn=loss_fn,
                weight_fn=weight_fn):
      return loss_fn(example, prediction) * weight_fn(step)

    metrics[name] = generic
  return metrics
