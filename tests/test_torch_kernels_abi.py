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

from frame_interpolation_tpu_torch.ops import (_kernels, conv3x3_pieces,
                                              conv_stack, conv_weights,
                                              upconv2x2, warp)

_C_TYPES = {'const void*': ctypes.c_void_p, 'void*': ctypes.c_void_p,
            'const void* const*': ctypes.POINTER(ctypes.c_void_p),
            'int': ctypes.c_int, 'int*': ctypes.POINTER(ctypes.c_int),
            'float': ctypes.c_float}
_C_RETURNS = {'int': ctypes.c_int, 'const char*': ctypes.c_char_p,
              'long long': ctypes.c_longlong}
# What the recorder returns for an entry point that reports a size.
_WORKSPACE_BYTES = 4 * 1234 + 2


class _Entry:
  """Stands in for a ctypes function: records its declaration and checks
  each call against it; the calls go into the library's log, in order."""

  def __init__(self, name, log):
    self.name, self.log = name, log

  def __call__(self, *args):
    assert len(args) == len(self.argtypes), (self.name, args)
    for kind, arg in zip(self.argtypes, args):
      if kind is ctypes.c_float:
        assert isinstance(arg, float), (self.name, args)
      elif kind is ctypes.POINTER(ctypes.c_void_p):
        assert isinstance(arg, ctypes.Array) and (
            arg._type_ is ctypes.c_void_p), (self.name, args)
      elif kind is ctypes.c_void_p and arg is None:
        pass  # NULL
      else:
        assert isinstance(arg, int), (self.name, args)
        if kind is ctypes.c_int:
          assert -2**31 <= arg < 2**31, (self.name, args)
    self.log.append((self.name, args))
    if self.restype is ctypes.c_longlong:
      return _WORKSPACE_BYTES
    return getattr(self, 'result', 0)


class _Library:
  def __init__(self):
    self.entries, self.log = {}, []

  def __getattr__(self, name):
    if name.startswith('__'):
      raise AttributeError(name)
    return self.entries.setdefault(name, _Entry(name, self.log))


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
        r'extern "C" (int|const char\*|long long) (\w+)\(([^)]*)\)\s*\{',
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
    assert entry.restype == _C_RETURNS[ret], name


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
  calls = library.log
  suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
  if launch == 'splat':
    # The splat asks for its workspace's size first, then launches.
    assert [name for name, _ in calls] == ['fi_splat_fixed_workspace_bytes',
                                           f'fi_splat_fixed_{suffix}']
    assert calls[0][1] == (2, 5, 7)
    calls = calls[1:]
  assert len(calls) == 1
  name, args = calls[0]
  assert name.endswith(suffix)
  assert args[:2] == (image.data_ptr(), flow.data_ptr())
  assert _kernels.LAUNCHES == {launch: 1}


def _stub_library(monkeypatch, launches):
  """The recorder as the kernels' library, CPU tensors standing in for
  CUDA ones (device checks and the stream stubbed)."""
  library = _declared()
  monkeypatch.setattr(_kernels, 'library', lambda: library)
  monkeypatch.setattr(_kernels, 'require_cuda', lambda *a, **k: None)
  monkeypatch.setattr(_kernels, 'stream_of', lambda t: 0)
  monkeypatch.setattr(_kernels, 'LAUNCHES', dict.fromkeys(launches, 0))
  return library


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rows_kernel_wrapper_passes_the_row_arguments(monkeypatch, dtype):
  # fi_warp_rows_*: the table of the slabs' addresses, their count and
  # rows, the flow and the output, then B, the slab's output rows, W, C,
  # its global first row and the frame's rows.
  library = _stub_library(monkeypatch, ['warp_rows'])
  slabs = [torch.zeros(2, 8, 7, 67, dtype=dtype) for _ in range(4)]
  flow = torch.zeros(2, 8, 7, 2)
  out = warp.backward_warp_rows_kernel(slabs, flow, 16, 32)
  assert tuple(out.shape) == (2, 8, 7, 67) and out.dtype == dtype
  calls = library.log
  suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
  assert [name for name, _ in calls] == [f'fi_warp_rows_{suffix}']
  args = calls[0][1]
  assert list(args[0]) == [t.data_ptr() for t in slabs]
  assert args[1:5] == (4, 8, flow.data_ptr(), out.data_ptr())
  assert args[5:11] == (2, 8, 7, 67, 16, 32)
  assert _kernels.LAUNCHES == {'warp_rows': 1}
  with pytest.raises(ValueError, match='at most 16 slabs'):
    warp.backward_warp_rows_kernel(
        [torch.zeros(2, 2, 7, 67, dtype=dtype)] * 17, flow[:, :2], 0, 34)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('channel', [0, 64, 131])
def test_slice_kernel_wrapper_passes_the_slice_and_the_pitch(
    monkeypatch, dtype, channel):
  # fi_warp_into_*: the image, the flow, the address of the slice's first
  # channel (the buffer's plus `channel` elements), the buffer's channels
  # as the pitch, then B, H, W, the image's C and the stream.
  library = _stub_library(monkeypatch, ['warp_slice'])
  c = 3 if channel == 131 else 64
  image = torch.zeros(2, 5, 7, c, dtype=dtype)
  flow = torch.zeros(2, 5, 7, 2)
  out = torch.zeros(2, 5, 7, 144, dtype=dtype)
  warp.backward_warp_into_kernel(image, flow, out, channel)
  suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
  assert [name for name, _ in library.log] == [f'fi_warp_into_{suffix}']
  args = library.log[0][1]
  assert args[:3] == (image.data_ptr(), flow.data_ptr(),
                      out.data_ptr() + channel * out.element_size())
  assert args[3:] == (144, 2, 5, 7, c, 0)
  assert _kernels.LAUNCHES == {'warp_slice': 1}
  with pytest.raises(ValueError, match='leave'):
    warp.backward_warp_into_kernel(image, flow, out, 144 - c + 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['deterministic', 'default'])
def test_splat_takes_the_fixed_order_entry_point_in_every_mode(
    monkeypatch, dtype, mode):
  # The splat has one route: fi_splat_fixed_*, with a workspace of the
  # size the library reports, whether or not
  # torch.use_deterministic_algorithms(True) is set.
  library = _stub_library(monkeypatch, ['splat'])
  g = torch.zeros(2, 5, 7, 67, dtype=dtype)
  flow = torch.zeros(2, 5, 7, 2)
  saved = torch.are_deterministic_algorithms_enabled()
  torch.use_deterministic_algorithms(mode == 'deterministic')
  try:
    acc = warp.splat_kernel(g, flow)
  finally:
    torch.use_deterministic_algorithms(saved)
  assert acc.shape == g.shape and acc.dtype == torch.float32
  suffix = 'bf16' if dtype == torch.bfloat16 else 'f32'
  calls = library.log
  assert [name for name, _ in calls] == ['fi_splat_fixed_workspace_bytes',
                                         f'fi_splat_fixed_{suffix}']
  assert calls[0][1] == (2, 5, 7)
  args = calls[1][1]
  assert args[:3] == (g.data_ptr(), flow.data_ptr(), acc.data_ptr())
  # The workspace's address, then B, H, W, C and the stream.
  assert isinstance(args[3], int) and args[4:] == (2, 5, 7, 67, 0)
  assert _kernels.LAUNCHES == {'splat': 1}


@pytest.mark.parametrize('splits', [1, 3])
@pytest.mark.parametrize('dtype,tf32,symbol', [
    (torch.bfloat16, False, 'fi_conv3x3_bf16'),
    (torch.float32, True, 'fi_conv3x3_tf32'),
    (torch.float32, False, 'fi_conv3x3_f32')])
def test_conv_wrapper_passes_what_the_entry_points_declare(
    monkeypatch, dtype, tf32, symbol, splits):
  # x, the packed weights, bias, y and the pool; the exact route also a
  # workspace of `splits` f32 outputs (none for 1 split) and the split
  # count it asked the library for; then N, H, W, Cin, Cout, the slope and
  # the stream.
  library = _stub_library(monkeypatch,
                          ['conv3x3_c64', 'conv3x3_wide', 'conv3x3_tf32'])
  library.fi_conv3x3_f32_splits.result = splits
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  x = torch.zeros(2, 6, 10, 64, dtype=dtype)
  weight, bias = torch.zeros(128, 64, 3, 3), torch.zeros(128)
  features, pooled = conv_stack.conv3x3_leaky_kernel(x, weight, bias, True)
  assert features.shape == (2, 6, 10, 128) and pooled.shape == (2, 3, 5, 128)
  calls = dict(library.log)
  exact = symbol == 'fi_conv3x3_f32'
  assert sorted(calls) == sorted([symbol] + (['fi_conv3x3_f32_splits']
                                             if exact else []))
  args = calls[symbol]
  assert args[0] == x.data_ptr() and args[3:5] == (features.data_ptr(),
                                                   pooled.data_ptr())
  if exact:
    assert calls['fi_conv3x3_f32_splits'] == (2, 6, 10, 64, 128)
    assert (args[5] is None) == (splits == 1) and args[6] == splits
    args = args[:5] + args[7:]
  assert args[5:10] == (2, 6, 10, 64, 128)
  # The TF32 route's launches also count as conv3x3_tf32.
  assert _kernels.LAUNCHES == {'conv3x3_c64': 0, 'conv3x3_wide': 1,
                               'conv3x3_tf32': int(symbol == 'fi_conv3x3_tf32')}


@pytest.mark.parametrize('dtype,tf32,symbol', [
    (torch.bfloat16, False, 'fi_upconv2x2_bf16'),
    (torch.bfloat16, True, 'fi_upconv2x2_bf16'),
    (torch.float32, True, 'fi_upconv2x2_tf32')])
def test_upconv_wrapper_passes_what_the_entry_points_declare(
    monkeypatch, dtype, tf32, symbol):
  # fi_upconv2x2_*: the coarse x, the weights packed (Cout, 2, 2, Cin) in
  # x's dtype (rounded to TF32 on that route), the bias in x's dtype's
  # value as f32, the fine output, then N, the coarse H and W, Cin, Cout
  # and the stream.
  library = _stub_library(monkeypatch, ['upconv2x2'])
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  x = torch.zeros(2, 3, 5, 128, dtype=dtype)
  weight = torch.nn.Parameter(torch.randn(64, 128, 2, 2))
  bias = torch.full((64,), 1.0 + 2.0**-12)
  out = upconv2x2.upconv2x2_kernel(x, weight, bias)
  assert out.shape == (2, 6, 10, 64) and out.dtype == dtype
  assert [name for name, _ in library.log] == [symbol]
  args = library.log[0][1]
  packed = conv_weights.packed(weight, dtype, symbol[len('fi_upconv2x2_'):])
  assert args[:2] == (x.data_ptr(), packed.data_ptr())
  assert tuple(packed.shape) == (64, 2, 2, 128)
  assert args[3] == out.data_ptr()
  assert args[4:] == (2, 3, 5, 128, 64, 0)
  assert _kernels.LAUNCHES == {'upconv2x2': 1}


@pytest.mark.parametrize('dtype,tf32,symbol', [
    (torch.bfloat16, False, 'fi_conv3x3_pieces_bf16'),
    (torch.bfloat16, True, 'fi_conv3x3_pieces_bf16'),
    (torch.float32, True, 'fi_conv3x3_pieces_tf32')])
@pytest.mark.parametrize('channels', [(144, 64), (32,)])
def test_pieces_wrapper_passes_what_the_entry_points_declare(
    monkeypatch, dtype, tf32, symbol, channels):
  # fi_conv3x3_pieces_*: each piece (the second NULL, with 0 channels,
  # where there is one), the pieces' channels, the weights packed (Cout,
  # K) in the pieces' dtype (rounded to TF32 on that route), the bias in
  # that dtype's value as f32, the output, then N, H, W, Cout, the slope
  # and the stream.
  library = _stub_library(monkeypatch, ['conv3x3_pieces'])
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
  pieces = [torch.zeros(2, 3, 5, c, dtype=dtype) for c in channels]
  weight = torch.nn.Parameter(torch.randn(64, sum(channels), 3, 3))
  bias = torch.full((64,), 1.0 + 2.0**-12)
  out = conv3x3_pieces.conv3x3_pieces_kernel(pieces, weight, bias)
  assert out.shape == (2, 3, 5, 64) and out.dtype == dtype
  assert [name for name, _ in library.log] == [symbol]
  args = library.log[0][1]
  route = 'bf16' if dtype == torch.bfloat16 else 'tf32'
  chunk = conv3x3_pieces.CHUNK_CHANNELS[dtype]
  packed = conv_weights.packed_pieces(weight, channels, dtype, route, chunk)
  assert tuple(packed.shape) == (
      64, sum(9 * -(-c // chunk) * chunk for c in channels))
  second = (pieces[1].data_ptr(), channels[1]) if len(channels) > 1 else (
      None, 0)
  assert args[:4] == (pieces[0].data_ptr(), second[0], channels[0],
                      second[1])
  assert args[4] == packed.data_ptr() and args[6] == out.data_ptr()
  assert args[7:] == (2, 3, 5, 64, 0.2, 0)
  assert _kernels.LAUNCHES == {'conv3x3_pieces': 1}
