"""film_net model modules of the PyTorch port."""

from .feature_extractor import FeatureExtractor, SubTreeExtractor
from .film_net import FilmNet, create_model, init_params
from .flow_estimator import FlowEstimator, PyramidFlowEstimator
from .fusion import Fusion

__all__ = [
    'FeatureExtractor', 'FilmNet', 'FlowEstimator', 'Fusion',
    'PyramidFlowEstimator', 'SubTreeExtractor', 'create_model', 'init_params',
]
