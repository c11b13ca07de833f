r"""One mid-frame interpolation CLI (PyTorch port).

  python3 -m frame_interpolation_tpu_torch.cli.interpolate_pair \
    --frame1 photos/one.png --frame2 photos/two.png \
    --params random --output_frame photos/middle.png

`--params random` runs the released configuration with weights drawn from
a fixed seed (a smoke test on machines without a checkpoint); reading a
parameter bundle is not ported yet. `--device` defaults to cuda and raises
when no GPU is visible.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..inference import Interpolator
from ..io import images
from ..models.film_net import create_model, init_params
from ..options import Options


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--frame1', required=True,
                      help='Filepath of the first frame.')
  parser.add_argument('--frame2', required=True,
                      help='Filepath of the second frame.')
  parser.add_argument('--params', required=True,
                      help="'random': released config, seeded random "
                      'weights.')
  parser.add_argument('--output_frame', required=True,
                      help='Filepath of the output mid-frame.')
  parser.add_argument('--align', type=int, default=64,
                      help='If >1, pad the input size so it divides with '
                      'this before inference.')
  parser.add_argument('--block_height', type=int, default=1,
                      help='Number of patches along height.')
  parser.add_argument('--block_width', type=int, default=1,
                      help='Number of patches along width.')
  parser.add_argument('--dtype_policy', default='float32',
                      choices=['float32', 'bfloat16'],
                      help='Compute dtype policy.')
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
  args = _parser().parse_args(argv)
  if args.params != 'random':
    raise ValueError(f"--params {args.params!r}: only 'random' is supported; "
                     'the parameter bundle reader is not ported yet.')
  options = Options.film_net_released(dtype_policy=args.dtype_policy)
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0))
  interpolator = Interpolator(model, options, align=args.align,
                              block_shape=(args.block_height,
                                           args.block_width),
                              device=args.device)
  image_1 = images.read_image(args.frame1)
  image_2 = images.read_image(args.frame2)
  if image_1.shape != image_2.shape:
    raise ValueError(
        f'Frame shapes differ: {image_1.shape} vs {image_2.shape}')
  batch_dt = np.full((1,), 0.5, dtype=np.float32)
  mid_frame = interpolator(image_1[np.newaxis], image_2[np.newaxis],
                           batch_dt)[0]
  images.write_image(args.output_frame, mid_frame)
  print(f'Wrote {args.output_frame}')


if __name__ == '__main__':
  main()
