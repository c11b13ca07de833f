"""Serving of the port: a load-once predictor for images and videos."""

from .predictor import Predictor

__all__ = ['Predictor']
