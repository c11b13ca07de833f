"""The in-training evaluation loop.

Port of frame_interpolation_tpu/training/eval_lib.py (the reference's
training/eval_lib.py): for each named eval dataset, run the model over
every batch, compute the metrics, summarize the first
`max_summary_batches` batches as image grids x0 | prediction | y | x1, and
write per-dataset scalar summaries. As in the reference, the metrics see
the raw prediction and the images are clipped to [0, 1] only for the
summaries (eval_lib.py:108-122). Runs under torch.inference_mode() on the
model's device.

As the JAX package jits the forward and the metrics, the forward and
every metric of a batch are one captured program on a CUDA device
(utils/programs.py; one graph a batch shape, released when the loop
ends): its metrics come back as one stacked device tensor, which the host
reads once a batch, as JAX's `jax.device_get` does, and the summary grids
read the replay's returned prediction. `graphs=False`, and the CPU, run
the same function eagerly, with the same one read a batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from .. import losses as losses_lib
from ..losses import vgg19
from ..models.film_net import FilmNet
from ..utils import programs
from . import metrics_lib
from .train_lib import batch_to_device


def eval_loop(model: FilmNet,
              datasets: Mapping[str, Iterable[Mapping[str, np.ndarray]]],
              metrics_fns: Mapping[str, metrics_lib.MetricFn],
              step: int,
              writer=None,
              max_summary_batches: int = 10,
              log_fn: Callable[[str], None] = print,
              graphs: Optional[bool] = None,
              ) -> Dict[str, Dict[str, float]]:
  """Evaluates every dataset; returns {dataset: {metric: mean}}.

  A dataset is re-iterable (data.dataset.EvalDataset, or a list of
  batches): numpy dicts with 'x0', 'x1', 'y' (B, H, W, 3) and 'time'
  (B, 1). `graphs`: the forward and metrics as a captured program (None:
  on a CUDA device); True on the CPU raises.
  """
  device = next(model.parameters()).device
  names = list(metrics_fns)

  def forward(example):
    """The prediction's image and every metric, stacked in `names`'
    order."""
    prediction = model(example['x0'], example['x1'], example['time'])
    # The training loss and the test losses share each image's VGG-19
    # tower, as the JAX package's one jitted program does.
    with vgg19.shared_features():
      values = torch.stack([metrics_fns[name](example, prediction, step)
                            .float().reshape(()) for name in names])
    return values, prediction['image']

  program = (programs.Program(forward, device, 'eval')
             if programs.resolve(graphs, device, 'eval_loop') else None)
  was_training = model.training
  model.eval()
  results: Dict[str, Dict[str, float]] = {}
  try:
    with torch.inference_mode():
      for dataset_name, dataset in datasets.items():
        batch_values = []
        for index, batch in enumerate(iter(dataset)):
          example = batch_to_device(batch, device)
          values, image = (program or forward)(example)
          # The batch's one read of the device.
          batch_values.append(dict(zip(names, values.tolist())))
          if writer is not None and index < max_summary_batches:
            grid = torch.cat([
                example['x0'][0], image[0].clamp(0.0, 1.0),
                example['y'][0], example['x1'][0]], dim=1)
            writer.image(f'eval/{dataset_name}/x0_pred_y_x1_{index}',
                         grid.float().cpu().numpy(), step)
        means = losses_lib.aggregate_batch_losses(batch_values)
        results[dataset_name] = means
        if writer is not None:
          for metric_name, value in means.items():
            writer.scalar(f'eval/{dataset_name}/{metric_name}', value, step)
        log_fn(f'eval[{dataset_name}] step {step}: ' +
               ', '.join(f'{k}={v:.5f}' for k, v in means.items()))
  finally:
    model.train(was_training)
    if program is not None:
      program.release()
  return results
