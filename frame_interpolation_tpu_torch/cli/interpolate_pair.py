r"""One mid-frame interpolation CLI (PyTorch port).

  python3 -m frame_interpolation_tpu_torch.cli.interpolate_pair \
    --frame1 photos/one.png --frame2 photos/two.png \
    --params <bundle or random> --output_frame photos/middle.png

`--params` is a bundle, the port's (options.json + state_dict.pt, what the
trainer exports) or the JAX package's (options.json + params.msgpack), a
TF release of the reference (SavedModel or checkpoint, the released
configuration; io/tf_import reads it without TensorFlow), or 'random':
the released configuration with weights drawn from seed 0 (a smoke test on
machines without a checkpoint). A bundle keeps its own dtype policy unless
`--dtype_policy` is given. `--time` is the JAX CLI's flag; film_net
predicts the midpoint only, so it takes 0.5 alone.
`--device` defaults to cuda and raises when no GPU is visible.

`--mesh data` splits the --block_height x --block_width patches over every
visible GPU (parallel.ShardedInterpolator); `--mesh spatial` splits the
rows of one full-frame forward over them (parallel.
SpatialShardedInterpolator), with the full-frame forward's output. With
one visible GPU both log so and run on it alone.

`--profile_dir` writes a torch.profiler trace of the interpolation to
`<dir>/trace.json`: the kernels and copies, and the port's `fi.upload`,
`fi.replay.pair` (`fi.capture.pair` on a first call) and `fi.download`
spans (utils/profiling.span).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ._common import (device_from_flag, load_interpolator_from_flag,
                      to_mesh_interpolator)


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--frame1', required=True,
                      help='Filepath of the first frame.')
  parser.add_argument('--frame2', required=True,
                      help='Filepath of the second frame.')
  parser.add_argument('--params', required=True,
                      help="A bundle (the port's or the JAX package's), a TF "
                      "release of the reference, or 'random': released "
                      'config, weights from seed 0.')
  parser.add_argument('--output_frame', required=True,
                      help='Filepath of the output mid-frame.')
  parser.add_argument('--align', type=int, default=64,
                      help='If >1, pad the input size so it divides with '
                      'this before inference.')
  parser.add_argument('--block_height', type=int, default=1,
                      help='Number of patches along height.')
  parser.add_argument('--block_width', type=int, default=1,
                      help='Number of patches along width.')
  parser.add_argument('--time', type=float, default=0.5,
                      help='Sub-frame time; film_net predicts the midpoint '
                      'only, so any value but 0.5 is refused.')
  parser.add_argument('--dtype_policy', default=None,
                      choices=['float32', 'bfloat16'],
                      help="Override the bundle's compute dtype policy.")
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  parser.add_argument('--mesh', default='none',
                      choices=['none', 'data', 'spatial'],
                      help="Over every visible GPU: 'data' splits the "
                      "patches, 'spatial' the rows of one full-frame "
                      'forward. Outputs match one device.')
  parser.add_argument('--profile_dir', default=None,
                      help='If set, write a torch.profiler trace of the '
                      'interpolation to <dir>/trace.json.')
  return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = _parser()
  args = parser.parse_args(argv)
  if args.time != 0.5:
    # The model replaces the time with 0.5 (models/film_net.py), so any
    # other value would write the midpoint under another name.
    parser.error(f'--time {args.time}: film_net predicts the midpoint '
                 '(0.5) only')
  from ..io import images
  from ..utils import profiling
  interpolator = load_interpolator_from_flag(
      args.params, args.align, (args.block_height, args.block_width),
      device_from_flag(args.device), dtype_policy=args.dtype_policy)
  interpolator = to_mesh_interpolator(
      interpolator, args.mesh, args.align,
      block_shape=(args.block_height, args.block_width), kind='pair')
  image_1 = images.read_image(args.frame1)
  image_2 = images.read_image(args.frame2)
  if image_1.shape != image_2.shape:
    raise ValueError(
        f'Frame shapes differ: {image_1.shape} vs {image_2.shape}')
  batch_dt = np.full((1,), args.time, dtype=np.float32)
  with profiling.trace_if(args.profile_dir):
    mid_frame = interpolator(image_1[np.newaxis], image_2[np.newaxis],
                             batch_dt)[0]
  images.write_image(args.output_frame, mid_frame)
  print(f'Wrote {args.output_frame}')


if __name__ == '__main__':
  main()
