"""Inference API of the PyTorch port."""

from .interpolator import Interpolator

__all__ = ['Interpolator']
