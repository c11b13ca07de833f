"""The CUDA kernels' C interface, checked on the CPU.

The kernels are built and run only on a GPU, but three places must agree
on each entry point: its `extern "C"` definition in `csrc/*.cu`, its
ctypes declaration in `ops/_kernels._declare`, and the arguments its
wrapper passes. A mismatch would otherwise show only on the card, as a
refused call or a crash.
"""
import ctypes
import re

import pytest
import torch

from frame_interpolation_tpu_torch.ops import _kernels, warp

_C_TYPES = {'const void*': ctypes.c_void_p, 'void*': ctypes.c_void_p,
            'int': ctypes.c_int, 'float': ctypes.c_float}


class _Entry:
  """Stands in for a ctypes function: records its declaration and checks
  each call against it."""

  def __init__(self, name):
    self.name, self.calls = name, []

  def __call__(self, *args):
    assert len(args) == len(self.argtypes), (self.name, args)
    for kind, arg in zip(self.argtypes, args):
      if kind is ctypes.c_float:
        assert isinstance(arg, float), (self.name, args)
      else:
        assert isinstance(arg, int), (self.name, args)
        if kind is ctypes.c_int:
          assert -2**31 <= arg < 2**31, (self.name, args)
    self.calls.append(args)
    return 0


class _Library:
  def __init__(self):
    self.entries = {}

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    return self.entries.setdefault(name, _Entry(name))


def _declared():
  library = _Library()
  _kernels._declare(library)
  return library


def _defined():
  """name -> (parameter types, return type) of every extern "C" function
  defined in csrc/*.cu."""
  found = {}
  for path in sorted(_kernels.CSRC_DIR.glob('*.cu')):
    for ret, name, params in re.findall(
        r'extern "C" (int|const char\*) (\w+)\(([^)]*)\)\s*\{',
        path.read_text()):
      kinds = [re.sub(r'\s*\w+$', '', p.strip()).replace(' *', '*')
               for p in params.split(',')]
      assert name not in found, f'{name} defined twice'
      found[name] = (kinds, ret)
  return found


def test_every_declared_entry_point_is_defined_with_its_arguments():
  declared, defined = _declared().entries, _defined()
  assert set(declared) == set(defined)
  for name, entry in declared.items():
    kinds, ret = defined[name]
    assert [_C_TYPES[k] for k in kinds] == entry.argtypes, name
    assert entry.restype == (ctypes.c_char_p if ret == 'const char*'
                             else ctypes.c_int), name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('wrapper,launch', [
    (warp.backward_warp_kernel, 'warp'),
    (warp.warp_planes_kernel, 'warp_planes'),
    (warp.splat_kernel, 'splat')])
def test_kernel_wrappers_pass_what_the_entry_points_declare(
    monkeypatch, wrapper, launch, dtype):
  # CPU tensors stand in for CUDA ones: the device checks and the stream
  # are stubbed, the library is the recorder above.
  library = _declared()
  monkeypatch.setattr(_kernels, 'library', lambda: library)
  monkeypatch.setattr(_kernels, 'require_cuda', lambda *a, **k: None)
  monkeypatch.setattr(_kernels, 'stream_of', lambda t: 0)
  monkeypatch.setattr(_kernels, 'LAUNCHES', {launch: 0})
  image = torch.zeros(2, 5, 7, 67, dtype=dtype)
  flow = torch.zeros(2, 5, 7, 2)
  wrapper(image, flow)
  calls = [(e.name, c) for e in library.entries.values() for c in e.calls]
  assert len(calls) == 1
  name, args = calls[0]
  assert name.endswith('bf16' if dtype == torch.bfloat16 else 'f32')
  assert args[:2] == (image.data_ptr(), flow.data_ptr())
  assert _kernels.LAUNCHES == {launch: 1}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rows_kernel_wrapper_passes_the_row_arguments(monkeypatch, dtype):
  # fi_warp_rows_*: the extension's rows (H_src) and the slab's (H_out),
  # then the slab's and the extension's global first rows and the frame's.
  library = _declared()
  monkeypatch.setattr(_kernels, 'library', lambda: library)
  monkeypatch.setattr(_kernels, 'require_cuda', lambda *a, **k: None)
  monkeypatch.setattr(_kernels, 'stream_of', lambda t: 0)
  monkeypatch.setattr(_kernels, 'LAUNCHES', {'warp_rows': 0})
  image = torch.zeros(2, 24, 7, 67, dtype=dtype)
  flow = torch.zeros(2, 8, 7, 2)
  out = warp.backward_warp_rows_kernel(image, flow, 16, 8, 32)
  assert tuple(out.shape) == (2, 8, 7, 67) and out.dtype == dtype
  calls = [(e.name, c) for e in library.entries.values() for c in e.calls]
  suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
  assert [name for name, _ in calls] == [f'fi_warp_rows_{suffix}']
  args = calls[0][1]
  assert args[:3] == (image.data_ptr(), flow.data_ptr(), out.data_ptr())
  assert args[3:11] == (2, 24, 8, 7, 67, 16, 8, 32)
  assert _kernels.LAUNCHES == {'warp_rows': 1}
