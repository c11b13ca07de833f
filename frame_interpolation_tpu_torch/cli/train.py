r"""Training CLI (PyTorch port).

Port of frame_interpolation_tpu/cli/train.py (the reference's
training/train.py). Experiment content comes from the presets in
training/configs (the released gin files mapped 1:1); run artifacts land in
`<base_folder>/<label>/{config.json,train,saved_model}`, the reference's
run-dir layout (README.md:186-195).

  python3 -m frame_interpolation_tpu_torch.cli.train \
    --experiment film_net-L1 \
    --train_file vimeo_train.tfrecord@200 \
    --base_folder runs --label run0

`--device` defaults to cuda and raises when no GPU is visible; `--device
cpu` runs the plain versions of the kernels on the host. `--eval_files`
with as many `--eval_names` evaluates those datasets at each save interval
(training/eval_lib.py; summaries under `<run>/eval`). The gin loader, the
VGG/Style losses and multi-host training wait for later slices (ROADMAP
A7's gin_compat, A8, A10); their flags are not accepted.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch


def _list(value: str):
  return [v for v in value.split(',') if v]


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--experiment', default='film_net-L1',
                      choices=['film_net-L1'],
                      help='Experiment preset (the released gin configs); '
                      'VGG and Style wait for the port of vgg19.')
  parser.add_argument('--base_folder', required=True,
                      help='Root folder for training runs.')
  parser.add_argument('--label', default='run0', help='Run descriptor.')
  parser.add_argument('--train_file', default=None,
                      help="Training TFRecord spec ('file' or 'file@N').")
  parser.add_argument('--train_files', type=_list, default=[],
                      help='Comma-separated training TFRecord specs of '
                      'several mixed sources.')
  parser.add_argument('--train_weights', type=_list, default=[],
                      help='Per-source sampling weights for --train_files '
                      '(uniform when empty).')
  parser.add_argument('--crop_sizes', type=_list, default=[],
                      help='Per-source crop sizes for --train_files; the '
                      'experiment crop size by default.')
  parser.add_argument('--crop_size', type=int, default=None,
                      help='Override the training crop size.')
  parser.add_argument('--batch_size', type=int, default=None,
                      help='Override the batch size.')
  parser.add_argument('--num_steps', type=int, default=None,
                      help='Override the number of training steps.')
  parser.add_argument('--save_interval', type=int, default=3000,
                      help='Checkpoint and summary interval.')
  parser.add_argument('--eval_files', type=_list, default=[],
                      help='Comma-separated eval TFRecord specs.')
  parser.add_argument('--eval_names', type=_list, default=[],
                      help='Names of the eval datasets, one per file.')
  parser.add_argument('--eval_max_examples', type=int, default=-1,
                      help='Max examples per eval dataset; -1 = all.')
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = _parser()
  args = parser.parse_args(argv)
  if len(args.eval_files) != len(args.eval_names):
    parser.error(f'--eval_files has {len(args.eval_files)} entries and '
                 f'--eval_names {len(args.eval_names)}; give one name per '
                 'file.')
  device = torch.device(args.device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('--device cuda requested but no GPU is visible to '
                       'torch.')

  from .. import losses as losses_lib
  from ..data import dataset as dataset_lib
  from ..models.film_net import FilmNet
  from ..training import configs, eval_lib, metrics_lib, sources, train_lib
  from ..utils import tensorboard

  config = configs.get_experiment(args.experiment)
  run_dir = os.path.join(args.base_folder, args.label)
  os.makedirs(run_dir, exist_ok=True)
  # The effective config, for reproducibility (train.py:85-87).
  with open(os.path.join(run_dir, 'config.json'), 'w') as f:
    json.dump(dataclasses.asdict(config), f, indent=2, default=str)

  batch_size = args.batch_size or config.dataset.batch_size
  crop_size = (args.crop_size if args.crop_size is not None
               else config.dataset.crop_size)
  opts = train_lib.TrainingOptions(
      learning_rate=config.learning_rate,
      learning_rate_decay_steps=config.learning_rate_decay_steps,
      learning_rate_decay_rate=config.learning_rate_decay_rate,
      learning_rate_staircase=config.learning_rate_staircase,
      num_steps=args.num_steps or config.num_steps,
      save_interval=args.save_interval)
  train_losses = losses_lib.training_losses(
      list(config.training_losses.names),
      loss_weight_schedules=list(config.training_losses.weight_schedules))
  source_list, weights = sources.build_training_sources(
      dataset_lib, config.dataset, args.train_file, args.train_files,
      args.crop_sizes, crop_size, args.train_weights)
  train_iterator = dataset_lib.create_training_iterator(
      source_list, batch_size=batch_size, weights=weights)

  eval_fn = None
  if args.eval_files:
    test_losses = losses_lib.test_losses(
        list(config.test_losses.names),
        loss_weight_schedules=list(config.test_losses.weight_schedules))
    eval_datasets = dataset_lib.create_eval_datasets(
        args.eval_files, args.eval_names, batch_size=1,
        max_examples=args.eval_max_examples)
    metrics_fns = metrics_lib.create_metrics_fns(test_losses, train_losses)
    eval_writer = tensorboard.create_writer(os.path.join(run_dir, 'eval'))

    def eval_fn(state, step):
      eval_lib.eval_loop(state.model, eval_datasets, metrics_fns, step,
                         writer=eval_writer)
      eval_writer.flush()

  train_lib.train(FilmNet(config.model), config.model, train_losses,
                  train_iterator, opts, run_dir,
                  init_generator=torch.Generator().manual_seed(0),
                  device=device,
                  augmentation_names=tuple(config.augmentations),
                  eval_fn=eval_fn)


if __name__ == '__main__':
  main()
