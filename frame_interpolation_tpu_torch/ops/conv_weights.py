"""The copies of conv weights that the conv kernels read, and the route
that picks them.

The hand-written convs (csrc/conv3x3.cu, csrc/upconv2x2.cu,
csrc/conv3x3_pieces.cu) and the fusion decoder's gathered convs
(models/fusion.py) read their weights not as the layer's OIHW parameter
but as a copy derived from it: packed K-major, in the compute dtype,
rounded to TF32 on that route, or with input channels gathered into
another order. Each copy is made once and kept here (`derived`) while its
weight is unchanged, because a captured graph (utils/programs.py) reads it
by address; a copy is made again after the weight is written to in place
or moved. A copy may be derived from another (the 3x3 pieces kernel's
packed copy of the fusion's gathered weights).

`route` is the one place under ops/ that reads
`torch.backends.cudnn.allow_tf32`, the flag under which cuDNN runs
PyTorch's own f32 convs in TF32: bf16 runs on the tensor cores in bf16;
f32 runs on them in TF32 while the flag is set, else in exact f32.
"""
from __future__ import annotations

import threading
from typing import Callable, Hashable, Optional, Sequence, TypeVar

import torch
import torch.nn.functional as F
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
  version counter, so theirs is made at every call; the copies made here
  are ordinary tensors, also under torch.inference_mode, so that a copy
  derived from a copy is kept too."""
  if weight.is_inference():
    return make()
  key = (weight._version, weight.data_ptr(), weight.device)
  with _LOCK:
    by_use = _DERIVED.setdefault(weight, {})
    cached = by_use.get(use)
    if cached is None or cached[0] != key:
      with torch.inference_mode(False):
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


def _pack(weights: Sequence[torch.Tensor], dtype: torch.dtype, route: str,
          chunk: int = 1) -> torch.Tensor:
  # K-major: row n holds the weights of output channel n in the kernels' K
  # order, weight after weight, each tap (ky, kx) major and input channel
  # minor, its channels padded with zero columns to a multiple of `chunk`.
  # One weight keeps the shape (Cout, kh, kw, Cin); several are (Cout, K).
  taps = [F.pad(w.detach().to(dtype).permute(0, 2, 3, 1),
                (0, -w.shape[1] % chunk)) for w in weights]
  packed = (taps[0] if len(taps) == 1 else
            torch.cat([t.flatten(1) for t in taps], dim=1)).contiguous()
  return round_tf32(packed) if route == 'tf32' else packed


def packed(weight: torch.Tensor, dtype: torch.dtype,
           route: str) -> torch.Tensor:
  """The kernels' copy of OIHW `weight`: (Cout, kh, kw, Cin) in `dtype`,
  rounded to TF32 on the 'tf32' route (`route`)."""
  return derived(weight, ('packed', dtype, route),
                 lambda: _pack([weight], dtype, route))


def packed_pieces(weight: torch.Tensor, channels: Sequence[int],
                  dtype: torch.dtype, route: str, chunk: int,
                  weights: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
  """The kernels' copy of OIHW `weight` for an input in pieces of
  `channels` input channels: the pieces' weights packed one after another
  along K, as `packed` packs one, each piece's channels padded with zero
  columns to a multiple of `chunk`; (Cout, K) with K = sum over pieces of
  kh * kw * padded channels. `weights`, one a piece, replace the slices of
  `weight`: the tensors of one derived copy (models/fusion.gathered), whose
  first keys the packed copy."""
  if weights is None:
    if sum(channels) != weight.shape[1]:
      raise ValueError(f'pieces of {sum(channels)} channels for a conv of '
                       f'{weight.shape[1]} input channels')
    return derived(weight, ('pieces', tuple(channels), dtype, route, chunk),
                   lambda: _pack(weight.split(list(channels), dim=1), dtype,
                                 route, chunk).flatten(1))
  return derived(weights[0], ('pieces', tuple(channels), dtype, route, chunk),
                 lambda: _pack(weights, dtype, route, chunk).flatten(1))
