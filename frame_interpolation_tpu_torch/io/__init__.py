"""Host-side I/O of the port: images, video, the flax weights bridge, the
port's state bundle, the JAX package's bundle and the reference's TF
releases (SavedModel and checkpoint, read without TensorFlow)."""

from .images import (natural_sort, read_image, read_image_uint8, to_uint8,
                     write_image)
from .params_io import (from_flax_params, is_jax_bundle, is_tf_checkpoint_dir,
                        is_tf_saved_model, load_params, load_state_bundle,
                        save_params, save_state_bundle, to_flax_params)
from .tf_bundle import BundleReader, latest_checkpoint, object_graph
from .tf_import import load_tf_params

__all__ = ['BundleReader', 'from_flax_params', 'is_jax_bundle',
           'is_tf_checkpoint_dir', 'is_tf_saved_model', 'latest_checkpoint',
           'load_params', 'load_state_bundle', 'load_tf_params',
           'natural_sort', 'object_graph', 'read_image', 'read_image_uint8',
           'save_params', 'save_state_bundle', 'to_flax_params', 'to_uint8',
           'write_image']
