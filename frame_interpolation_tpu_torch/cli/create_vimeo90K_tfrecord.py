r"""Vimeo-90K triplet TFRecord builder (PyTorch port).

Port of frame_interpolation_tpu/cli/create_vimeo90K_tfrecord.py (the
reference's datasets/create_vimeo90K_tfrecord.py): each line of
`tri_{train,test}list.txt` names a `seq/clip` directory under
`--input_dir` holding im1.png, im2.png and im3.png (train: 51,313
triplets in 200 shards; test: 3,782 in 3).

  python3 -m frame_interpolation_tpu_torch.cli.create_vimeo90K_tfrecord \
    --input_dir vimeo_triplet/sequences \
    --input_triplet_list_filepath vimeo_triplet/tri_trainlist.txt \
    --output_tfrecord_filepath vimeo_train.tfrecord --num_shards 200

Needs PIL.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

from ._common import triplet_record_parser, write_triplet_records

_IMAGES_MAP = {'frame_0': 'im1.png', 'frame_1': 'im2.png',
               'frame_2': 'im3.png'}


def main(argv: Optional[Sequence[str]] = None) -> int:
  parser = triplet_record_parser(__doc__.splitlines()[0], num_shards=200)
  parser.add_argument('--input_dir', required=True,
                      help='Root of the vimeo dataset sequences/ directory.')
  parser.add_argument('--input_triplet_list_filepath', required=True,
                      help='tri_{train|test}list.txt of triplet '
                      'subdirectories.')
  args = parser.parse_args(argv)
  with open(args.input_triplet_list_filepath) as f:
    triplet_names = [line.strip() for line in f if line.strip()]
  triplet_dicts = [
      {key: os.path.join(args.input_dir, name, basename)
       for key, basename in _IMAGES_MAP.items()}
      for name in triplet_names
  ]
  return write_triplet_records(args, triplet_dicts)


if __name__ == '__main__':
  logging.basicConfig(level=logging.INFO)
  main()
