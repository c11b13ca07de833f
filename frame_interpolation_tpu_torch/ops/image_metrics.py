"""SSIM and PSNR with `tf.image` parity, on NHWC tensors (PyTorch).

Port of frame_interpolation_tpu/ops/image_metrics.py, which matches the
reference's `tf.image.ssim` / `tf.image.psnr`:

  * SSIM: 11x11 Gaussian window (sigma 1.5), VALID padding, k1 = 0.01,
    k2 = 0.03, per channel, averaged over positions and channels; cs comes
    from the filtered x*y and x**2 + y**2 (not centred moments), as TF's
    helper computes it.
  * PSNR: 20*log10(max_val) - 10*log10(mse), mse over (H, W, C).

The Gaussian filter is one depthwise VALID conv per image channel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
  coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
  g = np.exp(-(coords**2) / (2.0 * sigma**2))
  k2d = np.outer(g, g)
  k2d /= k2d.sum()
  return k2d.astype(np.float32)


# (size, sigma, device) -> the Gaussian window on the device, built once
# and kept: the SSIM loss may run inside a captured train step
# (utils/programs.py), which cannot capture a host-to-device copy and reads
# the window by address.
_WINDOWS = {}


def _gaussian_window(size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
  key = (size, sigma, device)
  window = _WINDOWS.get(key)
  if window is None:
    window = _WINDOWS.setdefault(key, torch.from_numpy(
        _gaussian_kernel(size, sigma)).to(device))
  return window


def _filter2d_valid(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
  """Depthwise VALID 2-D filter of (B, H, W, C) with a (k, k) kernel."""
  c = x.shape[-1]
  k = kernel2d.shape[0]
  weight = kernel2d.reshape(1, 1, k, k).expand(c, 1, k, k)
  out = F.conv2d(x.permute(0, 3, 1, 2), weight, groups=c)
  return out.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
  """Per-image SSIM, shape (B,), matching tf.image.ssim."""
  x = img1.float()
  y = img2.float()
  kernel = _gaussian_window(filter_size, filter_sigma, x.device)
  c1 = (k1 * max_val)**2
  c2 = (k2 * max_val)**2

  mean0 = _filter2d_valid(x, kernel)
  mean1 = _filter2d_valid(y, kernel)
  num0 = mean0 * mean1 * 2.0
  den0 = mean0.square() + mean1.square()
  luminance = (num0 + c1) / (den0 + c1)

  num1 = _filter2d_valid(x * y, kernel) * 2.0
  den1 = _filter2d_valid(x.square() + y.square(), kernel)
  cs = (num1 - num0 + c2) / (den1 - den0 + c2)
  return (luminance * cs).mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
  """Per-image PSNR, shape (B,), matching tf.image.psnr."""
  mse = (img1.float() - img2.float()).square().mean(dim=(-3, -2, -1))
  return 20.0 * np.log10(max_val) - 10.0 * torch.log10(mse)
