"""VGG-19 perceptual and style (Gram) losses (PyTorch).

Port of frame_interpolation_tpu/losses/vgg19.py (itself the reference's
losses/vgg19_loss.py), with its numerical quirks, because the released
Style checkpoint was trained against them:

  * the weights come from the MatConvNet `imagenet-vgg-verydeep-19.mat`
    release, read on the host with scipy.io (imported when first needed)
    and kept as constant tensors, once per (file, device): no gradient, no
    place in the optimizer;
  * inputs are scaled to [0, 255] and the ImageNet mean (123.68, 116.779,
    103.939) is subtracted;
  * the tower runs conv1_1..conv5_2 with ReLU, with 2x2 stride-2 SAME
    average pooling after each block, which divides by the true window at
    odd edges (tf.nn.avg_pool);
  * vgg_loss = sum_i w_i * mean|feat_ref_i - feat_img_i| over conv{1..5}_2,
    divided by 255;
  * style_loss = sum_i w_i * mean((G(ref_i/255) - G(img_i/255))^2) with
    the Gram matrix G(F) = F^T F / (h*w) in f32, F the (b, h*w, c)
    flattening of a layer's features;
  * default layer weights [1/2.6, 1/4.8, 1/3.7, 1/5.6, 10/1.5];
  * an optional (B, H, W, 1) mask is resized to each layer (bilinear,
    tf.image.resize semantics) and multiplies the features' differences
    (vgg) or the features (style).

Images are NHWC (B, H, W, 3), as the port's batches are; the tower runs
NCHW, permuted once at its input. The reference image's features carry no
gradient: the losses differentiate with respect to the prediction only, as
JAX's do. The tower is plain convs and the Gram matrix a matmul, outside
any kernel of the JAX package.

Both losses of one objective read the same towers: under `jax.jit` XLA
merges their identical `vgg_features` calls, so the JAX package's Style
step runs one tower forward per image and back-propagates through one.
Inside a `shared_features()` scope the port does the same: each image's
features are computed once per (input tensor, weights file, grad mode)
and handed to every loss that asks, so autograd sums the vgg and style
cotangents into one backward through the prediction's tower. The train
step, `losses.compute_weighted_loss` and eval's metrics open the scope;
outside it every call computes its own towers.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import resize

_DEFAULT_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)
_IMAGENET_MEAN = (123.6800, 116.7790, 103.9390)

# MatConvNet layer indices of the conv layers the tower needs, in order.
_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30)
_CONV_NAMES = ('conv1_1', 'conv1_2', 'conv2_1', 'conv2_2', 'conv3_1',
               'conv3_2', 'conv3_3', 'conv3_4', 'conv4_1', 'conv4_2',
               'conv4_3', 'conv4_4', 'conv5_1', 'conv5_2')
# Average pooling follows these layers (the end of each VGG block).
_POOL_AFTER = ('conv1_2', 'conv2_2', 'conv3_4', 'conv4_4')
_LOSS_LAYERS = ('conv1_2', 'conv2_2', 'conv3_2', 'conv4_2', 'conv5_2')

Weights = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@functools.lru_cache(maxsize=2)
def load_vgg_weights(model_filepath: str) -> Tuple[Tuple[np.ndarray,
                                                         np.ndarray], ...]:
  """(HWIO kernel, bias) pairs from the MatConvNet .mat release.

  The nested indexing follows the MatConvNet cell-array layout the
  reference reads: layers[0][i][0][0][2][0][{0,1}].
  """
  import scipy.io as sio
  raw = sio.loadmat(model_filepath)
  layers = raw['layers'][0]
  out = []
  for index in _CONV_INDICES:
    kernel = np.asarray(layers[index][0][0][2][0][0], dtype=np.float32)
    bias = np.asarray(layers[index][0][0][2][0][1], dtype=np.float32)
    out.append((kernel, bias.reshape(-1)))
  return tuple(out)


def save_vgg_weights(model_filepath: str,
                     kernels: Sequence[Tuple[np.ndarray, np.ndarray]]
                     ) -> None:
  """Writes the tower's 14 (HWIO kernel, bias) pairs as a MatConvNet .mat
  that `load_vgg_weights` reads: a `layers` cell array whose conv slots
  hold records (name, type, weights={kernel, bias column}), the others
  placeholder records."""
  import scipy.io as sio
  if len(kernels) != len(_CONV_INDICES):
    raise ValueError(f'{len(kernels)} conv layers; VGG-19 to conv5_2 has '
                     f'{len(_CONV_INDICES)}')
  record_type = [('name', 'O'), ('type', 'O'), ('weights', 'O')]
  layers = np.empty((1, max(_CONV_INDICES) + 1), dtype=object)
  for i in range(layers.shape[1]):
    record = np.zeros((1, 1), dtype=record_type)
    record[0, 0]['name'], record[0, 0]['type'] = 'relu_or_pool', 'misc'
    record[0, 0]['weights'] = np.empty((0, 0), dtype=object)
    layers[0, i] = record
  for index, name, (kernel, bias) in zip(_CONV_INDICES, _CONV_NAMES,
                                         kernels):
    cell = np.empty((1, 2), dtype=object)
    cell[0, 0] = np.asarray(kernel, np.float32)
    cell[0, 1] = np.asarray(bias, np.float32).reshape(-1, 1)
    record = np.zeros((1, 1), dtype=record_type)
    record[0, 0]['name'], record[0, 0]['type'] = name, 'conv'
    record[0, 0]['weights'] = cell
    layers[0, index] = record
  sio.savemat(model_filepath, {'layers': layers})


@functools.lru_cache(maxsize=4)
def _tower_weights(model_filepath: str, device: torch.device) -> Weights:
  """The tower's (OIHW weight, bias) constants on `device`."""
  return tuple(
      (torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(
          device), torch.from_numpy(b.copy()).to(device))
      for k, b in load_vgg_weights(model_filepath))


@functools.lru_cache(maxsize=None)
def _imagenet_mean(device: torch.device) -> torch.Tensor:
  """The (1, 3, 1, 1) mean on `device`, made once: a captured train step
  (utils/programs.py) reads it by address and cannot copy from the host."""
  return torch.tensor(_IMAGENET_MEAN, dtype=torch.float32,
                      device=device).reshape(1, 3, 1, 1)


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
  """2x2 stride-2 SAME average pooling of NCHW `x` (tf.nn.avg_pool): a
  window cut by an odd edge divides by the elements it holds."""
  return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


def vgg_features(image: torch.Tensor,
                 model_filepath: str) -> Dict[str, torch.Tensor]:
  """The tower's conv outputs by layer name, NCHW; `image` is NHWC RGB in
  [0, 255]."""
  weights = _tower_weights(model_filepath, image.device)
  mean = _imagenet_mean(image.device)
  net = image.float().permute(0, 3, 1, 2) - mean
  feats: Dict[str, torch.Tensor] = {}
  for (weight, bias), name in zip(weights, _CONV_NAMES):
    net = F.relu(F.conv2d(net, weight, bias, padding=1))
    feats[name] = net
    if name in _POOL_AFTER:
      net = avg_pool_same(net)
  return feats


def _layer_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """The (B, H, W, 1) mask resized to an NCHW layer, as (B, 1, h, w)."""
  resized = resize.resize_bilinear(mask, (like.shape[2], like.shape[3]))
  return resized.permute(0, 3, 1, 2)


# The open scope's features on this thread: (id of the [0, 1] input, file,
# grad mode) -> (the input, its features); None outside a scope.
_scope = threading.local()


@contextlib.contextmanager
def shared_features():
  """Within the scope the losses compute each image's tower once per
  (input tensor, weights file, grad mode) and share it; the cache ends
  with the scope. A scope opened inside another joins it. Safe under
  CUDA-graph capture: the scope lives for one Python call of the
  captured function."""
  if getattr(_scope, 'cache', None) is not None:
    yield
    return
  _scope.cache = {}
  try:
    yield
  finally:
    _scope.cache = None


def _features(image: torch.Tensor,
              model_filepath: str) -> Dict[str, torch.Tensor]:
  """The features of a [0, 1] image (scaled to [0, 255] here), shared
  within a `shared_features()` scope. The cache holds the input, so its
  id stays its own while the scope lives."""
  cache = getattr(_scope, 'cache', None)
  if cache is None:
    return vgg_features(image * 255.0, model_filepath)
  key = (id(image), model_filepath, torch.is_grad_enabled())
  if key not in cache:
    cache[key] = (image, vgg_features(image * 255.0, model_filepath))
  return cache[key][1]


def _reference_features(reference: torch.Tensor,
                        model_filepath: str) -> Dict[str, torch.Tensor]:
  with torch.no_grad():
    return _features(reference, model_filepath)


def vgg_loss(image: torch.Tensor,
             reference: torch.Tensor,
             vgg_model_file: str,
             weights: Optional[Sequence[float]] = None,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Perceptual loss between [0, 1] RGB images (B, H, W, 3)."""
  if not weights:
    weights = _DEFAULT_WEIGHTS
  feats_ref = _reference_features(reference, vgg_model_file)
  feats_img = _features(image, vgg_model_file)
  total = 0.0
  for name, weight in zip(_LOSS_LAYERS, weights):
    diff = (feats_ref[name] - feats_img[name]).abs()
    if mask is not None:
      diff = diff * _layer_mask(mask, diff)
    total = total + diff.mean() * weight
  return total / 255.0


def _gram(features: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
  """F^T F / (h*w) of NCHW features, F their (b, h*w, c) flattening."""
  _, _, h, w = features.shape
  if mask is not None:
    features = features * _layer_mask(mask, features)
  flat = features.float().flatten(2)  # (b, c, h*w) = F^T
  return torch.matmul(flat, flat.transpose(1, 2)) / float(h * w)


def style_loss(image: torch.Tensor,
               reference: torch.Tensor,
               vgg_model_file: str,
               weights: Optional[Sequence[float]] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Gram-matrix style loss between [0, 1] RGB images (B, H, W, 3)."""
  if not weights:
    weights = _DEFAULT_WEIGHTS
  feats_ref = _reference_features(reference, vgg_model_file)
  feats_img = _features(image, vgg_model_file)
  total = 0.0
  for name, weight in zip(_LOSS_LAYERS, weights):
    with torch.no_grad():
      gram_ref = _gram(feats_ref[name] / 255.0, mask)
    gram_img = _gram(feats_img[name] / 255.0, mask)
    total = total + (gram_ref - gram_img).square().mean() * weight
  return total
