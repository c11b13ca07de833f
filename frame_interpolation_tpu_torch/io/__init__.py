"""Host-side I/O of the port: images, video, the flax weights bridge, the
port's state bundle and the JAX package's bundle."""

from .images import (natural_sort, read_image, read_image_uint8, to_uint8,
                     write_image)
from .params_io import (from_flax_params, is_jax_bundle, load_params,
                        load_state_bundle, save_params, save_state_bundle,
                        to_flax_params)

__all__ = ['from_flax_params', 'is_jax_bundle', 'load_params',
           'load_state_bundle', 'natural_sort', 'read_image',
           'read_image_uint8', 'save_params', 'save_state_bundle',
           'to_flax_params', 'to_uint8', 'write_image']
