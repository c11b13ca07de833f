"""Host-side I/O of the port: images, video, the flax weights bridge and
the port's state bundle."""

from .images import (natural_sort, read_image, read_image_uint8, to_uint8,
                     write_image)
from .params_io import (from_flax_params, load_state_bundle,
                        save_state_bundle, to_flax_params)

__all__ = ['from_flax_params', 'load_state_bundle', 'natural_sort',
           'read_image', 'read_image_uint8', 'save_state_bundle',
           'to_flax_params', 'to_uint8', 'write_image']
