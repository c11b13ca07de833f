"""Host-side I/O of the port: images and the flax weights bridge."""

from .images import read_image, to_uint8, write_image
from .params_io import from_flax_params, to_flax_params

__all__ = ['from_flax_params', 'read_image', 'to_flax_params', 'to_uint8',
           'write_image']
