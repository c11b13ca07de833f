r"""Directory / video interpolation CLI (PyTorch port).

Port of frame_interpolation_tpu/cli/interpolate_dir.py (the reference's
eval/interpolator_cli.py): for each directory matching --pattern,
interpolate recursively between its naturally sorted frames and write
`interpolated_frames/frame_%03d.png`, plus `interpolated.mp4` with
--output_video when ffmpeg is found.

By default the frame tree of each chunk of pairs runs on the device
(inference/recursion.interpolate_frontier_streaming, the feature-cached
DFS); --streaming runs the reference's in-order generator instead. Both
write the same frames.

  python3 -m frame_interpolation_tpu_torch.cli.interpolate_dir \
    --pattern "photos/*" --params random --times_to_interpolate 3 \
    --output_video

`--params` is 'random' (the released config with weights from seed 0) or
a bundle: the port's (options.json + state_dict.pt, what the trainer
exports) or the JAX package's (options.json + params.msgpack). `--device`
defaults to cuda and raises when no GPU is visible.
`--mesh data` splits each chunk of the frame tree's nodes over every
visible GPU (parallel.ShardedVideoInterpolator: the chunked tree); it
takes the device frame tree alone, without --streaming or patches. With
one visible GPU it logs so and runs on it alone.
`--profile_dir` writes a torch.profiler trace of every directory's
interpolation to `<dir>/trace.json`, with the port's spans
(utils/profiling.span): `fi.chunk` and `fi.fetch_wait` of the device frame
tree, `fi.upload` and the programs' `fi.replay.*` and `fi.capture.*`.
Not carried over from the JAX CLI: --warp_impl, --fold_convs and
--conv_stack choose between TPU execution layouts, which the port does not
have.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
from typing import List, Optional, Sequence

from ._common import (device_from_flag, load_interpolator_from_flag,
                      to_mesh_interpolator)

_INPUT_EXT = ('png', 'jpg', 'jpeg')


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--pattern', required=True,
                      help='Glob pattern of directories with input frames.')
  parser.add_argument('--params', required=True,
                      help="A bundle (the port's or the JAX package's), a TF "
                      "release of the reference, or 'random': released "
                      'config, weights from seed 0.')
  parser.add_argument('--times_to_interpolate', type=int, default=5,
                      help='Recursive midpoint depth: 2^T - 1 frames '
                      'between each input pair.')
  parser.add_argument('--fps', type=int, default=30,
                      help='Frames per second of interpolated.mp4.')
  parser.add_argument('--align', type=int, default=64,
                      help='If >1, pad the input size so it divides with '
                      'this before inference.')
  parser.add_argument('--block_height', type=int, default=1,
                      help='Patches along height; 1 = no tiling.')
  parser.add_argument('--block_width', type=int, default=1,
                      help='Patches along width; 1 = no tiling.')
  parser.add_argument('--output_video', action='store_true',
                      help='Also write interpolated.mp4 (needs ffmpeg).')
  parser.add_argument('--streaming', action='store_true',
                      help='The in-order generator (the reference\'s '
                      'evaluation order) instead of the device frame tree.')
  parser.add_argument('--cache_features',
                      action=argparse.BooleanOptionalAction, default=True,
                      help='With --streaming, extract each frame\'s '
                      'features once (the same frames).')
  parser.add_argument('--max_batch', type=int, default=8,
                      help='The batch cap of --mesh data\'s chunked '
                      'tree.')
  parser.add_argument('--pairs_per_chunk', type=int, default=0,
                      help='Input pairs expanded per device chunk; 0 sizes '
                      'it from --device_memory_budget_gb.')
  parser.add_argument('--device_memory_budget_gb', type=float, default=4.0,
                      help='Device memory (GiB) for the frame trees in '
                      'flight.')
  parser.add_argument('--num_shards', type=int, default=1,
                      help='Hosts splitting the directory list (one '
                      'invocation per host, each with its --shard_index).')
  parser.add_argument('--shard_index', type=int, default=0,
                      help='This host\'s shard in [0, num_shards).')
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  parser.add_argument('--mesh', default='none', choices=['none', 'data'],
                      help="'data' splits each frame-tree chunk over every "
                      'visible GPU; outputs match one device.')
  parser.add_argument('--profile_dir', default=None,
                      help='If set, write a torch.profiler trace of the '
                      'interpolation to <dir>/trace.json.')
  return parser


def process_directory(directory: str, interpolator,
                      args: argparse.Namespace) -> None:
  from ..inference import recursion
  from ..io import images, video
  input_frames: List[str] = []
  for ext in _INPUT_EXT:
    input_frames.extend(glob.glob(os.path.join(directory, f'*.{ext}')))
  input_frames = images.natural_sort(input_frames)
  if len(input_frames) < 2:
    logging.warning('Skipping %s: fewer than 2 input frames.', directory)
    return
  logging.info('Generating in-between frames for %s.', directory)
  times = args.times_to_interpolate
  frames_dir = os.path.join(directory, 'interpolated_frames')
  # Both modes stream: frames load on demand and are written as they come,
  # so host memory stays O(1) and device memory is bounded.
  if args.streaming:
    if args.cache_features:
      # as_uint8: the writers quantize anyway, the device by the same rule.
      frame_iter = recursion.interpolate_recursively_cached(
          input_frames, times, interpolator, as_uint8=True)
    else:
      frame_iter = recursion.interpolate_recursively_from_files(
          input_frames, times, interpolator)
  else:
    frame_iter = recursion.interpolate_frontier_streaming(
        input_frames, times, interpolator, max_batch=args.max_batch,
        pairs_per_chunk=args.pairs_per_chunk or None,
        memory_budget_bytes=int(args.device_memory_budget_gb * 2**30),
        as_uint8=True)
  os.makedirs(frames_dir, exist_ok=True)

  def stream():
    for index, frame in enumerate(frame_iter):
      images.write_image(
          os.path.join(frames_dir, f'frame_{index:03d}.png'), frame)
      yield frame

  if args.output_video and video.have_ffmpeg():
    out = os.path.join(directory, 'interpolated.mp4')
    video.write_video(out, stream(), fps=args.fps)
    logging.info('Output video saved at %s.', out)
  else:
    if args.output_video:
      logging.error('ffmpeg not found; skipping video for %s.', directory)
    for _ in stream():
      pass
  logging.info('Output frames saved in %s.', frames_dir)


def main(argv: Optional[Sequence[str]] = None) -> None:
  parser = _parser()
  args = parser.parse_args(argv)
  if args.mesh != 'none':
    if args.streaming:
      parser.error('--mesh data shards the device frame tree; it does not '
                   'apply to the in-order --streaming generator.')
    if args.block_height * args.block_width > 1:
      parser.error('--mesh data shards whole frame-tree nodes; for patches '
                   'use interpolate_pair --mesh data.')
  device = device_from_flag(args.device)
  directories = sorted(d for d in glob.glob(args.pattern)
                       if os.path.isdir(d))
  if not directories:
    raise ValueError(f'No directories match pattern {args.pattern}')
  if args.num_shards > 1:
    from ..utils import fanout
    directories = fanout.shard(directories, args.shard_index,
                               args.num_shards)
    logging.info('Shard %d/%d: %d directories.', args.shard_index,
                 args.num_shards, len(directories))
  interpolator = load_interpolator_from_flag(
      args.params, args.align, (args.block_height, args.block_width), device)
  interpolator = to_mesh_interpolator(interpolator, args.mesh, args.align,
                                      kind='video')
  from ..utils import profiling
  with profiling.trace_if(args.profile_dir):
    for directory in directories:
      process_directory(directory, interpolator, args)


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
