r"""Xiph triplet TFRecord builder, Xiph-2K and Xiph-4K (PyTorch port).

Port of frame_interpolation_tpu/cli/create_xiph_tfrecord.py (the
reference's datasets/create_xiph_tfrecord.py): `--num_clips` clips of
`--num_frames` frames in one flat directory, in name order; each odd
frame is the middle of its even neighbours. `--scale_factor 2` (the
default) gives Xiph-2K; `--center_crop_factor 2 --scale_factor 1` gives
Xiph-4K.

  python3 -m frame_interpolation_tpu_torch.cli.create_xiph_tfrecord \
    --input_dir xiph_frames --output_tfrecord_filepath xiph_2k.tfrecord

Needs PIL.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from ._common import triplet_record_parser, write_triplet_records

_OFFSETS = {'frame_0': -1, 'frame_1': 0, 'frame_2': 1}


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = triplet_record_parser(__doc__.splitlines()[0], num_shards=2)
  parser.add_argument('--input_dir', required=True,
                      help='Directory with the 800 Xiph frames.')
  parser.add_argument('--center_crop_factor', type=int, default=1,
                      help='Center-crop factor; 2 keeps the center half '
                      '(Xiph-4K).')
  parser.add_argument('--scale_factor', type=int, default=2,
                      help='Downsample factor (2 for Xiph-2K).')
  parser.add_argument('--num_clips', type=int, default=8,
                      help='Number of clips.')
  parser.add_argument('--num_frames', type=int, default=100,
                      help='Frames per clip.')
  args = parser.parse_args(argv)
  frames_list = sorted(os.listdir(args.input_dir))
  triplet_dicts = []
  for clip_index in range(args.num_clips):
    for frame_index in range(1, args.num_frames - 1, 2):
      index = clip_index * args.num_frames + frame_index
      triplet_dicts.append({
          key: os.path.join(args.input_dir, frames_list[index + offset])
          for key, offset in _OFFSETS.items()
      })
  return write_triplet_records(args, triplet_dicts,
                               scale_factor=args.scale_factor,
                               center_crop_factor=args.center_crop_factor)


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
