"""Weights made from the seed, on the run's device, in a few large calls.

film_net: every conv kernel lecun-normal, truncated at two standard
deviations, every bias zero: the scaling of the released code's
initialiser (flax's lecun_normal, as the model's own init uses). One draw
of a truncated unit normal for all kernels from a generator on the device,
then each kernel's slice scaled by sqrt(1 / fan_in) / 0.8796 (the standard
deviation of a unit normal truncated to [-2, 2]). Float32, as the
parameters are held under both precision policies.

VGG-19 to conv5_2 at its true widths: He-scaled normal kernels and
0.1-scaled normal biases from a numpy RandomState, written as the
MatConvNet `.mat` layout that the port's perceptual losses read
(imagenet-vgg-verydeep-19.mat is not public in this tree).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import training as ref_training
from .traffic import frames as traffic


def film_net(shapes: Dict[str, Tuple[int, ...]], seed: int,
             device) -> Dict[str, torch.Tensor]:
  """The model's parameters by name (`reference.film_net.parameter_shapes`)."""
  kernels = [k for k, s in shapes.items() if len(s) == 4]
  total = sum(math.prod(shapes[k]) for k in kernels)
  generator = torch.Generator(device=device)
  generator.manual_seed(traffic.derived_seed(seed, 'film_net'))
  flat = torch.empty(total, dtype=torch.float32, device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
  out, offset = {}, 0
  for name, shape in shapes.items():
    if len(shape) != 4:
      out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
      continue
    n = math.prod(shape)
    std = math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])) / .87962566103423978
    out[name] = flat[offset:offset + n].view(shape).mul_(std)
    offset += n
  return out


def vgg19(seed: int, channels: Sequence[int] = ref_training.VGG_CHANNELS
          ) -> List[Tuple[np.ndarray, np.ndarray]]:
  """14 (HWIO kernel, bias) pairs."""
  rng = np.random.RandomState(traffic.derived_seed(seed, 'vgg19') % 2**32)
  cin, out = 3, []
  for cout in channels:
    out.append(((rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin))**0.5).astype(
        np.float32), (rng.randn(cout) * 0.1).astype(np.float32)))
    cin = cout
  return out


_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30)


def write_vgg_mat(path: str, kernels) -> None:
  """The MatConvNet layout: a `layers` cell array whose conv slots hold
  records (name, type, weights = {kernel, bias column}), the others
  placeholder records."""
  import scipy.io as sio
  record_type = [('name', 'O'), ('type', 'O'), ('weights', 'O')]
  layers = np.empty((1, max(_CONV_INDICES) + 1), dtype=object)
  for i in range(layers.shape[1]):
    record = np.zeros((1, 1), dtype=record_type)
    record[0, 0]['name'], record[0, 0]['type'] = 'relu_or_pool', 'misc'
    record[0, 0]['weights'] = np.empty((0, 0), dtype=object)
    layers[0, i] = record
  for index, name, (kernel, bias) in zip(_CONV_INDICES,
                                         ref_training.VGG_NAMES, kernels):
    cell = np.empty((1, 2), dtype=object)
    cell[0, 0] = np.asarray(kernel, np.float32)
    cell[0, 1] = np.asarray(bias, np.float32).reshape(-1, 1)
    record = np.zeros((1, 1), dtype=record_type)
    record[0, 0]['name'], record[0, 0]['type'] = name, 'conv'
    record[0, 0]['weights'] = cell
    layers[0, index] = record
  sio.savemat(path, {'layers': layers})


def vgg19_tensors(kernels, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
  """The pairs as (OIHW, bias) tensors, for the reference."""
  return [(torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(
      device), torch.from_numpy(b).to(device)) for k, b in kernels]
