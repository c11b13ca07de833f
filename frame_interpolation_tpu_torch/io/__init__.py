"""Host-side I/O of the port: images, the flax weights bridge and the
port's state bundle."""

from .images import read_image, to_uint8, write_image
from .params_io import (from_flax_params, load_state_bundle,
                        save_state_bundle, to_flax_params)

__all__ = ['from_flax_params', 'load_state_bundle', 'read_image',
           'save_state_bundle', 'to_flax_params', 'to_uint8', 'write_image']
