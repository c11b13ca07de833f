"""Convolutions in TF32 for the plain reference, as the card runs a
float32 configuration whose switches let cuDNN take TF32.

With `torch.backends.cudnn.allow_tf32` on, every conv of the port's
float32 step runs on TF32 tensor cores, forward and both halves of the
backward, on channels_last (NHWC) tensors: the port keeps its activations
so, and its own conv kernel rounds its operands as cuDNN's NHWC forward
kernels do. cuDNN picks its kernels by layout and shape, and they differ
in what they do to a float32 operand: on an H100 its NHWC forward and
input-gradient kernels round both operands to nearest TF32, most of its
weight-gradient kernels truncate them, and its NCHW kernels run the
3-channel image convs and some small weight gradients in exact float32.
The reference keeps NCHW tensors; so inside `TF32Convs()` each conv that
PyTorch runs (`aten.convolution`, `aten.convolution_backward`) gets its
4-d operands as channels_last copies and runs with TF32 allowed, and
cuDNN's kernels for that layout give the precision the configuration
states. Everything else (the Gram products, the warps, the optimizer)
stays float32, as `matmul_allow_tf32` off keeps the program's.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_CONVS = (torch.ops.aten.convolution.default,
          torch.ops.aten.convolution_backward.default)


def channels_last(args):
  """The arguments with each 4-d tensor as a channels_last copy."""
  return [a.contiguous(memory_format=torch.channels_last)
          if isinstance(a, torch.Tensor) and a.dim() == 4 else a
          for a in args]


class TF32Convs(TorchDispatchMode):
  """Inside, every conv runs in cuDNN's TF32 on channels_last operands;
  every other operation as the switches outside say (the reference sets
  them off)."""

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if func not in _CONVS:
      return func(*args, **kwargs)
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
      return func(*channels_last(args), **kwargs)
    finally:
      torch.backends.cudnn.allow_tf32 = allowed
