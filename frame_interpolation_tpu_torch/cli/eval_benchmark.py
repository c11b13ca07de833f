r"""Benchmark evaluation CLI: PSNR/SSIM on triplet TFRecords (PyTorch port).

Port of frame_interpolation_tpu/cli/eval_benchmark.py (the reference's
eval/eval_cli.py): iterates an eval TFRecord, clips the predictions to
[0, 1] for the metrics only, and writes one `results.csv` row per example
plus a mean row, optional PNG dumps of every image-shaped tensor, and a
`readme.txt` of what was evaluated.

  python3 -m frame_interpolation_tpu_torch.cli.eval_benchmark \
    --params <bundle or random> --tfrecord middlebury.tfrecord@3 \
    --output_dir /tmp/middlebury_eval --metrics l1,l2,ssim,psnr

`--params` is 'random' (the released config, weights from seed 0) or a
bundle, the port's or the JAX package's. `--gin_config` reads a
reference-style eval gin file (eval/config/*.gin), which supplies the
tfrecord (unless `--tfrecord` is given), the metrics and max_examples.
`--device` defaults to cuda and raises when no GPU is visible.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ._common import device_from_flag, load_interpolator_from_flag


def run_evaluation(interpolator, tfrecord: str, output_dir: str,
                   max_examples: int, metrics: List[str],
                   output_frames: bool = False,
                   batch_size: int = 1,
                   model_description: str = '') -> Dict[str, float]:
  """Runs the benchmark loop; returns {metric: mean}."""
  from .. import losses as losses_lib
  from ..data import dataset as dataset_lib
  from ..io import images

  os.makedirs(output_dir, exist_ok=True)
  with open(os.path.join(output_dir, 'readme.txt'), 'w') as f:
    print('Results for:', file=f)
    print(f' model:   {model_description}', file=f)
    print(f' tfrecord: {tfrecord}', file=f)

  test_losses = losses_lib.test_losses(list(metrics),
                                       loss_weights=[1.0] * len(metrics))
  all_losses: Dict[str, List[float]] = {name: [] for name in test_losses}

  with open(os.path.join(output_dir, 'results.csv'), 'w') as csv_file:
    print(', '.join(['key'] + list(test_losses)), file=csv_file)
    for example in dataset_lib.eval_dataset(tfrecord, batch_size=batch_size,
                                            max_examples=max_examples,
                                            with_path=True):
      outputs = interpolator.interpolate_all_outputs(
          example['x0'], example['x1'], example['time'][:, 0])
      # Clip only for the metrics, as the reference does
      # (eval_cli.py:160-166).
      prediction = {'image': outputs['image'].clamp(0.0, 1.0)}
      for name in ('x0_warped', 'x1_warped'):
        if name in outputs:
          prediction[name] = outputs[name]
      batch_y = interpolator.to_device(example['y'])

      dump_tensors = {}
      if output_frames:
        combined = {k: v for k, v in example.items()
                    if not isinstance(v, list)}
        combined.update({k: v for k, v in outputs.items()
                         if isinstance(v, torch.Tensor)})
        for name, tensor in combined.items():
          if isinstance(tensor, torch.Tensor):
            tensor = tensor.float().cpu().numpy()
          if tensor.ndim == 4 and tensor.shape[-1] in (1, 3):
            dump_tensors[name] = tensor

      # One row per example whatever the batch size, the reference's row
      # format (eval_cli.py:160-170).
      for i in range(int(batch_y.shape[0])):
        paths = example.get('path') or []
        path = paths[i] if i < len(paths) else ''
        key = path.rsplit('.', 1)[0].rsplit(os.sep)[-1] if path else (
            f'example_{sum(len(v) for v in all_losses.values()):05d}')

        for name, tensor in dump_tensors.items():
          images.write_image(
              os.path.join(output_dir, f'{key}_{name}.png'), tensor[i])

        prediction_i = {k: v[i:i + 1] for k, v in prediction.items()}
        metric_example = {'y': batch_y[i:i + 1]}
        row = []
        with torch.inference_mode():
          for loss_name, (loss_fn, weight_fn) in test_losses.items():
            value = float(loss_fn(metric_example, prediction_i) *
                          weight_fn(0))
            row.append(value)
            all_losses[loss_name].append(value)
        print(f'{key}, ' + ', '.join(str(v) for v in row), file=csv_file)

    totals = {name: float(np.mean(values)) if values else float('nan')
              for name, values in all_losses.items()}
    if any(values for values in all_losses.values()):
      print('mean, ' + ', '.join(str(totals[name]) for name in test_losses),
            file=csv_file)
  return totals


def _list(value: str):
  return [v for v in value.split(',') if v]


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--params', required=True,
                      help="A bundle (the port's or the JAX package's), or "
                      "'random': released config, weights from seed 0.")
  parser.add_argument('--tfrecord', default=None,
                      help="Eval TFRecord spec ('file' or 'file@N').")
  parser.add_argument('--gin_config', default=None,
                      help='A reference-style eval gin file; supplies the '
                      'tfrecord, metrics and max_examples.')
  parser.add_argument('--output_dir', required=True,
                      help='Directory for results.csv and frames.')
  parser.add_argument('--max_examples', type=int, default=-1,
                      help='Limit of examples; -1 = all.')
  parser.add_argument('--metrics', type=_list,
                      default=['l1', 'l2', 'ssim', 'psnr'],
                      help='Comma-separated metric names (losses registry).')
  parser.add_argument('--output_frames', action='store_true',
                      help='Dump every image-shaped tensor of each example '
                      'as PNG.')
  parser.add_argument('--batch_size', type=int, default=1,
                      help='Eval batch size.')
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = _parser().parse_args(argv)
  tfrecord, metrics, max_examples = (args.tfrecord, args.metrics,
                                     args.max_examples)
  if args.gin_config:
    from ..training.configs import gin_compat
    eval_config = gin_compat.load_eval_gin(args.gin_config)
    tfrecord = tfrecord or eval_config.tfrecord
    metrics = list(eval_config.metrics)
    max_examples = eval_config.max_examples
  if not tfrecord:
    raise ValueError('Provide --tfrecord or --gin_config.')
  device = device_from_flag(args.device)
  interpolator = load_interpolator_from_flag(args.params, 64, None, device)
  totals = run_evaluation(
      interpolator, tfrecord, args.output_dir, max_examples,
      metrics, output_frames=args.output_frames,
      batch_size=args.batch_size, model_description=args.params)
  print('mean:', ', '.join(f'{k}={v:.6f}' for k, v in totals.items()))


if __name__ == '__main__':
  main()
