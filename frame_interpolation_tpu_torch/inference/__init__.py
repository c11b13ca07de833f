"""Inference API of the PyTorch port: pairs, the frame tree, recursion."""

from .cached_tree import dfs_schedule
from .interpolator import Interpolator, load_interpolator
from .recursion import (frontier_pairs_per_chunk, interpolate_frontier,
                        interpolate_frontier_streaming,
                        interpolate_recursively,
                        interpolate_recursively_cached,
                        interpolate_recursively_from_files,
                        num_interpolated_frames, num_output_frames)

__all__ = [
    'Interpolator', 'dfs_schedule', 'frontier_pairs_per_chunk',
    'interpolate_frontier', 'interpolate_frontier_streaming',
    'interpolate_recursively', 'interpolate_recursively_cached',
    'interpolate_recursively_from_files', 'load_interpolator',
    'num_interpolated_frames', 'num_output_frames',
]
