"""Ops of the PyTorch port: plain tensor code plus the CUDA kernel wrappers."""

from .conv_stack import conv3x3_leaky, conv3x3_leaky_plain
from .pyramid import (avg_pool_2x, build_image_pyramid, concatenate_pyramids,
                      flow_pyramid_synthesis, multiply_pyramid, pyramid_warp)
from .resize import resize_bilinear, resize_nearest
from .tiling import (crop_to_bounding_box, image_to_patches, pad_to_align,
                     patches_to_image)
from .warp import backward_warp, backward_warp_plain

__all__ = [
    'avg_pool_2x', 'backward_warp', 'backward_warp_plain',
    'build_image_pyramid', 'concatenate_pyramids', 'conv3x3_leaky',
    'conv3x3_leaky_plain', 'crop_to_bounding_box', 'flow_pyramid_synthesis',
    'image_to_patches', 'multiply_pyramid', 'pad_to_align',
    'patches_to_image', 'pyramid_warp', 'resize_bilinear', 'resize_nearest',
]
