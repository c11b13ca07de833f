"""The benchmark's tests: the harness, its yardstick and its reference on
the CPU at tiny sizes; the tests marked `card` run on the card.

  python3 -m pytest film_bench/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)


@pytest.fixture
def card():
  """Skips the test where no CUDA card is visible."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card')
  return torch.device('cuda', 0)


@pytest.fixture
def tiny_vgg(monkeypatch):
  """VGG-19's layers at a test's widths."""
  from film_bench import weights
  from film_bench.tests import helpers
  original = weights.vgg19
  monkeypatch.setattr(weights, 'vgg19',
                      lambda seed, channels=helpers.TINY_VGG: original(
                          seed, channels))
