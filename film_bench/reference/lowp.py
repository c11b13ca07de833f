"""Lower precisions for the controls: roundings applied to a conv's inputs.

The control of a configuration is its reference computed one precision
below what the configuration states. Each function here rounds a float32
tensor to that precision and returns float32, so the reference's convs
and products then accumulate in float32 as the hardware's low-precision
paths do:

  * 'bfloat16': round to nearest even, 8 significant bits;
  * 'float8_e4m3': per-tensor scaled to the format's largest magnitude
    (448), rounded to e4m3 (4 significant bits), scaled back: the usual
    recipe for fp8 inference.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def bfloat16(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.bfloat16).float()


def float8_e4m3(x: torch.Tensor) -> torch.Tensor:
  amax = x.detach().abs().amax().float().clamp_min(1e-30)
  scale = E4M3_MAX / amax
  return (x * scale).to(torch.float8_e4m3fn).float() / scale


QUANT = {'float32': None, 'bfloat16': bfloat16, 'float8_e4m3': float8_e4m3}

# The precision one below each precision a configuration states, where the
# control is the reference at it (a configuration may name the program's
# own path instead, `program_control`).
BELOW = {'bfloat16': 'float8_e4m3', 'float32_tf32': 'bfloat16'}
