"""Data plane of the port: TFRecord IO, Example codec, triplet datasets,
augmentations."""

from .augmentations import apply_data_augmentation, data_augmentations
from .dataset import (EvalDataset, TrainingSource, create_eval_datasets,
                      create_training_iterator, eval_dataset)
from .example_proto import decode_example, encode_example
from .records import make_triplet_example, parse_triplet_example
from .tfrecord import (TFRecordWriter, read_records, read_sharded,
                       shard_filename, sharded_filenames)

__all__ = [
    'EvalDataset', 'TFRecordWriter', 'TrainingSource',
    'apply_data_augmentation', 'create_eval_datasets',
    'create_training_iterator', 'data_augmentations', 'decode_example',
    'encode_example', 'eval_dataset', 'make_triplet_example',
    'parse_triplet_example', 'read_records', 'read_sharded',
    'shard_filename', 'sharded_filenames',
]
