r"""UCF101 interpolation-test triplet TFRecord builder (PyTorch port).

Port of frame_interpolation_tpu/cli/create_ucf101_tfrecord.py (the
reference's datasets/create_ucf101_tfrecord.py): each subdirectory of
`--input_dir` holds frame_00.png, frame_01_gt.png and frame_02.png (379
triplets, 2 shards).

  python3 -m frame_interpolation_tpu_torch.cli.create_ucf101_tfrecord \
    --input_dir ucf101_interp_ours --output_tfrecord_filepath ucf101.tfrecord

Needs PIL.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from ._common import triplet_record_parser, write_triplet_records

_IMAGES_MAP = {'frame_0': 'frame_00.png', 'frame_1': 'frame_01_gt.png',
               'frame_2': 'frame_02.png'}


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = triplet_record_parser(__doc__.splitlines()[0], num_shards=2)
  parser.add_argument('--input_dir', required=True,
                      help='Root of the UCF101 triplets.')
  args = parser.parse_args(argv)
  clips = sorted(d for d in os.listdir(args.input_dir)
                 if os.path.isdir(os.path.join(args.input_dir, d)))
  triplet_dicts = [
      {key: os.path.join(args.input_dir, clip, basename)
       for key, basename in _IMAGES_MAP.items()}
      for clip in clips
  ]
  return write_triplet_records(args, triplet_dicts)


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
