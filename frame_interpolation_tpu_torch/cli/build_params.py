r"""Checkpoint -> deployable bundle converter (PyTorch port).

Port of frame_interpolation_tpu/cli/build_params.py (the reference's
training/build_saved_model_cli.py), with two routes to the port's bundle
(options.json + state_dict.pt), which every inference entry point loads:

  * a training run of the port: the newest `<base>/<label>/train/
    ckpt-<step>.pt` becomes `<base>/<label>/saved_model` (or --output),
    with the model's hyperparameters from the options.json that the
    trainer writes beside the checkpoints (the released configuration for
    a run that has none);
  * a bundle of the JAX package (options.json + params.msgpack) becomes a
    bundle of the port at --output.

  python3 -m frame_interpolation_tpu_torch.cli.build_params \
    --base_folder runs --label run0

  python3 -m frame_interpolation_tpu_torch.cli.build_params \
    --jax_bundle style_bundle --output style_bundle_torch

A TF SavedModel or checkpoint of the reference needs TensorFlow: the JAX
package's build_params converts it (--tf_model) into a JAX bundle, which
the second route, or any entry point of the port, then reads; so does a
JAX training run (orbax). Everything stays on the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--base_folder', default=None,
                      help='Root folder of training runs.')
  parser.add_argument('--label', default=None,
                      help='Run label under base_folder.')
  parser.add_argument('--jax_bundle', default=None,
                      help='A bundle of the JAX package to convert instead.')
  parser.add_argument('--output', default=None,
                      help='Output bundle directory (default: '
                      '<base>/<label>/saved_model).')
  return parser


def _latest_checkpoint(run_dir: str):
  """(state_dict, Options, step) of the newest checkpoint of a run."""
  import torch

  from ..io import params_io
  from ..models.film_net import create_model
  from ..options import Options
  from ..training import train_lib
  train_dir = os.path.join(run_dir, 'train')
  if not os.path.isdir(train_dir):
    raise FileNotFoundError(f'No checkpoint under {train_dir}')
  ckpt = train_lib.CheckpointManager(train_dir)
  step = ckpt.latest_step()
  if step is None:
    raise FileNotFoundError(f'No checkpoint under {train_dir}')
  payload = torch.load(os.path.join(train_dir, f'ckpt-{step}.pt'),
                       map_location='cpu', weights_only=True)
  if os.path.isfile(os.path.join(train_dir, params_io.OPTIONS_FILE)):
    options = params_io.read_options(train_dir)
  else:
    options = Options.film_net_released()
  # Strict: a checkpoint of another configuration raises here.
  create_model(options).load_state_dict(payload['model'])
  return payload['model'], options, step


def main(argv: Optional[Sequence[str]] = None) -> str:
  """Writes the bundle; returns its directory."""
  parser = _parser()
  args = parser.parse_args(argv)
  from ..io import params_io
  if args.jax_bundle:
    if not args.output:
      parser.error('--output is required with --jax_bundle')
    if not params_io.is_jax_bundle(args.jax_bundle):
      raise FileNotFoundError(
          f'{args.jax_bundle}: no options.json + {params_io.PARAMS_FILE}')
    state, options = params_io.load_params(args.jax_bundle)
    output = args.output
    source = args.jax_bundle
  else:
    if not (args.base_folder and args.label):
      parser.error('Provide --base_folder and --label, or --jax_bundle.')
    run_dir = os.path.join(args.base_folder, args.label)
    state, options, step = _latest_checkpoint(run_dir)
    output = args.output or os.path.join(run_dir, 'saved_model')
    source = f'{run_dir} at step {step}'
  params_io.save_state_bundle(output, state, options)
  print(f'Wrote the bundle of {source} to {output}')
  return output


if __name__ == '__main__':
  main()
