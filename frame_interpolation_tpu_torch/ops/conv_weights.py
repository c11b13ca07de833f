"""The copies of conv weights that the conv kernels read, and the route
that picks them.

The hand-written convs (csrc/conv3x3.cu, csrc/upconv2x2.cu) and the
fusion decoder's gathered convs (models/fusion.py) read their weights not
as the layer's OIHW parameter but as a copy derived from it: packed
K-major, in the compute dtype, rounded to TF32 on that route, or with
input channels gathered into another order. Each copy is made once and
kept here (`derived`) while its weight is unchanged, because a captured
graph (utils/programs.py) reads it by address; a copy is made again after
the weight is written to in place or moved.

`route` is the one place under ops/ that reads
`torch.backends.cudnn.allow_tf32`, the flag under which cuDNN runs
PyTorch's own f32 convs in TF32: bf16 runs on the tensor cores in bf16;
f32 runs on them in TF32 while the flag is set, else in exact f32.
"""
from __future__ import annotations

import threading
from typing import Callable, Hashable, TypeVar

import torch
from torch.utils.weak import WeakTensorKeyDictionary

T = TypeVar('T')

# weight -> {use: (key, copy)}. Shards on one device share their replica's
# weights from threads of their own: the lock makes each copy once. It is
# re-entrant, so that a copy may be made from another derived copy.
_DERIVED = WeakTensorKeyDictionary()
_LOCK = threading.RLock()


def route(dtype: torch.dtype) -> str:
  """The conv kernels' route for x of `dtype`: 'bf16', or for f32 'tf32'
  while `torch.backends.cudnn.allow_tf32` is set, else 'f32'."""
  if dtype == torch.bfloat16:
    return 'bf16'
  if dtype == torch.float32:
    return 'tf32' if torch.backends.cudnn.allow_tf32 else 'f32'
  raise ValueError(f'the conv kernels take bf16 or f32; got {dtype}')


def derived(weight: torch.Tensor, use: Hashable, make: Callable[[], T]) -> T:
  """`make()`, the copy of `weight` for `use`, made once a weight and use
  and again after the weight is written to in place or moved. A copy for
  one use never replaces the copy for another. Inference tensors keep no
  version counter, so theirs is made at every call."""
  if weight.is_inference():
    return make()
  key = (weight._version, weight.data_ptr(), weight.device)
  with _LOCK:
    by_use = _DERIVED.setdefault(weight, {})
    cached = by_use.get(use)
    if cached is None or cached[0] != key:
      cached = (key, make())
      by_use[use] = cached
    return cached[1]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
  """f32 `x` rounded to the nearest TF32 value (10 mantissa bits), ties
  away from zero, as cvt.rna.tf32.f32 and cuDNN's TF32 convs round: a new
  f32 tensor whose 13 low mantissa bits are zero."""
  if x.dtype != torch.float32:
    raise ValueError(f'round_tf32 takes f32; got {x.dtype}')
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _pack(weight: torch.Tensor, dtype: torch.dtype,
          route: str) -> torch.Tensor:
  # K-major: row n holds the kh * kw * Cin weights of output channel n in
  # the kernels' K order, tap (ky, kx) major and input channel minor.
  packed = weight.detach().to(dtype).permute(0, 2, 3, 1).contiguous()
  return round_tf32(packed) if route == 'tf32' else packed


def packed(weight: torch.Tensor, dtype: torch.dtype,
           route: str) -> torch.Tensor:
  """The kernels' copy of OIHW `weight`: (Cout, kh, kw, Cin) in `dtype`,
  rounded to TF32 on the 'tf32' route (`route`)."""
  return derived(weight, ('packed', dtype, route),
                 lambda: _pack(weight, dtype, route))
