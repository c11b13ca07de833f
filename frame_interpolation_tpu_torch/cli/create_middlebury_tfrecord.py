r"""Middlebury-Other triplet TFRecord builder (PyTorch port).

Port of frame_interpolation_tpu/cli/create_middlebury_tfrecord.py (the
reference's datasets/create_middlebury_tfrecord.py): the pairs are
`<input_dir>/other-data/<clip>/{frame10,frame11}.png`, the golden middle
frames `<input_dir>/other-gt-interp/<clip>/frame10i11.png` (12 triplets,
3 shards).

  python3 -m frame_interpolation_tpu_torch.cli.create_middlebury_tfrecord \
    --input_dir middlebury --output_tfrecord_filepath middlebury.tfrecord

Needs PIL.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from ._common import triplet_record_parser, write_triplet_records

_IMAGES_MAP = {'frame_0': 'frame10.png', 'frame_1': 'frame10i11.png',
               'frame_2': 'frame11.png'}


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = triplet_record_parser(__doc__.splitlines()[0], num_shards=3)
  parser.add_argument('--input_dir', required=True,
                      help='Root of the Middlebury-Other data.')
  parser.add_argument('--input_pairs_foldername', default='other-data',
                      help='Folder with the input frame pairs.')
  parser.add_argument('--golden_foldername', default='other-gt-interp',
                      help='Folder with the golden middle frames.')
  args = parser.parse_args(argv)
  pairs_dir = os.path.join(args.input_dir, args.input_pairs_foldername)
  clips = sorted(d for d in os.listdir(pairs_dir)
                 if os.path.isdir(os.path.join(pairs_dir, d)))
  folder_of = {'frame_0': args.input_pairs_foldername,
               'frame_1': args.golden_foldername,
               'frame_2': args.input_pairs_foldername}
  triplet_dicts = [
      {key: os.path.join(args.input_dir, folder_of[key], clip, basename)
       for key, basename in _IMAGES_MAP.items()}
      for clip in clips
  ]
  return write_triplet_records(args, triplet_dicts)


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
