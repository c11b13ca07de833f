"""TF32 rounding in plain numpy: what a TF32 conv's operands should be.

TF32 keeps float32's sign and 8-bit exponent and 10 of its 23 mantissa
bits. The H100's TF32 tensor-core instructions read only those 19 bits of
each float32 they are given, so the caller rounds first; cuDNN's TF32
convs and PTX's cvt.rna.tf32.f32 round to nearest, ties away from zero.
In the bits: add half of the lowest kept bit (0x1000) to the magnitude,
then clear the 13 bits below it. A carry out of the mantissa raises the
exponent, as rounding up to the next power of two should. NaN payloads
are not preserved; the tests feed no NaN.
"""
from __future__ import annotations

import numpy as np
import torch

_HALF = np.uint32(0x1000)
_KEEP = np.uint32(0xFFFFE000)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
  """float32 `x` rounded to nearest TF32 (ties away from zero), as float32
  on x's device."""
  if x.dtype != torch.float32:
    raise ValueError(f'round_tf32 takes float32; got {x.dtype}')
  bits = np.ascontiguousarray(x.detach().cpu().numpy()).view(np.uint32)
  rounded = ((bits + _HALF) & _KEEP).view(np.float32)
  return torch.from_numpy(rounded).to(x.device)
