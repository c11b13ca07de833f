"""A reader and writer for the msgpack that flax's serialization writes.

The JAX package stores its weights with `flax.serialization.to_bytes`
(frame_interpolation_tpu/io/params_io.py): msgpack of the parameter tree,
whose leaves are ext records. A machine that runs the port may have no
`msgpack` and no flax, so this module reads and writes that subset itself:

  * maps with string keys, arrays, str, bin, ints, floats, bool and nil;
  * the ext record code 1 (an ndarray) and code 3 (a numpy scalar, written
    as a 0-d ndarray), whose payload is itself msgpack: the array
    (shape, dtype name, C-order bytes), flax's `_ndarray_to_bytes`;
  * the chunked-array map {'__msgpack_chunked_array__': True, 'shape',
    'chunks'} that flax writes for leaves over MAX_CHUNK_SIZE bytes.

`restore` is flax's `msgpack_restore`: arrays come back as numpy arrays
over the input's own buffer (no copy), except bfloat16 ones, which numpy
has no type for: they come back as torch.bfloat16 tensors through a view
of their 16-bit words. Anything else (another ext code, complex included;
a truncated input; trailing bytes; a map key that is not a string) raises
MsgpackError.

`serialize` is flax's `msgpack_serialize` for a tree of dicts with array
leaves: the same encoding msgpack-python picks for each value, so flax's
`msgpack_restore` reads what it writes, bit for bit.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: leaves above it are written in chunks.
MAX_CHUNK_SIZE = 2**30
_CHUNKED = '__msgpack_chunked_array__'
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class MsgpackError(ValueError):
  """The input is not msgpack of the subset flax writes."""


# ---- reading ------------------------------------------------------------------


class _Reader:
  """Decodes one msgpack object from a buffer, without copying bin data."""

  def __init__(self, data: memoryview):
    self._data = data
    self._pos = 0

  def take(self, n: int) -> memoryview:
    end = self._pos + n
    if end > len(self._data):
      raise MsgpackError(f'truncated input: {n} bytes wanted at offset '
                         f'{self._pos} of {len(self._data)}')
    view = self._data[self._pos:end]
    self._pos = end
    return view

  def _uint(self, n: int) -> int:
    return int.from_bytes(self.take(n), 'big')

  def _int(self, n: int) -> int:
    return int.from_bytes(self.take(n), 'big', signed=True)

  def at_end(self) -> bool:
    return self._pos == len(self._data)

  def read(self) -> Any:
    code = self.take(1)[0]
    if code <= 0x7f:
      return code
    if code >= 0xe0:
      return code - 0x100
    if 0x80 <= code <= 0x8f:
      return self._map(code & 0x0f)
    if 0x90 <= code <= 0x9f:
      return self._array(code & 0x0f)
    if 0xa0 <= code <= 0xbf:
      return self._str(code & 0x1f)
    if code == 0xc0:
      return None
    if code == 0xc2:
      return False
    if code == 0xc3:
      return True
    if code in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
      return bytes(self.take(self._uint(1 << (code - 0xc4))))
    if code in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
      size = self._uint(1 << (code - 0xc7))
      return self._ext(size)
    if code == 0xca:
      return struct.unpack('>f', self.take(4))[0]
    if code == 0xcb:
      return struct.unpack('>d', self.take(8))[0]
    if 0xcc <= code <= 0xcf:  # uint 8/16/32/64
      return self._uint(1 << (code - 0xcc))
    if 0xd0 <= code <= 0xd3:  # int 8/16/32/64
      return self._int(1 << (code - 0xd0))
    if 0xd4 <= code <= 0xd8:  # fixext 1/2/4/8/16
      return self._ext(1 << (code - 0xd4))
    if code in (0xd9, 0xda, 0xdb):  # str 8/16/32
      return self._str(self._uint(1 << (code - 0xd9)))
    if code in (0xdc, 0xdd):  # array 16/32
      return self._array(self._uint(2 << (code - 0xdc)))
    if code in (0xde, 0xdf):  # map 16/32
      return self._map(self._uint(2 << (code - 0xde)))
    raise MsgpackError(f'unknown msgpack type byte 0x{code:02x}')

  def _str(self, n: int) -> str:
    try:
      return str(self.take(n), 'utf-8')
    except UnicodeDecodeError as e:
      raise MsgpackError(f'a str that is not utf-8: {e}') from e

  def _array(self, n: int) -> List[Any]:
    return [self.read() for _ in range(n)]

  def _map(self, n: int) -> Dict[str, Any]:
    out = {}
    for _ in range(n):
      key = self.read()
      if not isinstance(key, str):
        raise MsgpackError(f'a map key of type {type(key).__name__}; flax '
                           'writes string keys only')
      out[key] = self.read()
    return out

  def _ext(self, size: int) -> Any:
    code = self._int(1)
    payload = self.take(size)
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
      raise MsgpackError(f'ext code {code}: only ndarrays (1) and numpy '
                         'scalars (3) are read')
    array = _ndarray_from_payload(payload)
    return array if code == _EXT_NDARRAY else array[()]


def _ndarray_from_payload(payload: memoryview):
  """flax `_ndarray_from_bytes`: msgpack (shape, dtype name, C-order
  bytes), the array built over `payload` itself."""
  reader = _Reader(payload)
  header = reader.take(1)[0]
  if header != 0x93:
    raise MsgpackError('an ndarray payload that is not a 3-element array')
  shape = reader.read()
  name = reader.read()
  code = reader.take(1)[0]
  if code not in (0xc4, 0xc5, 0xc6):
    raise MsgpackError('an ndarray payload without its bin bytes')
  data = reader.take(reader._uint(1 << (code - 0xc4)))
  if not reader.at_end():
    raise MsgpackError('trailing bytes in an ndarray payload')
  if (not isinstance(shape, list) or
      not all(isinstance(d, int) and d >= 0 for d in shape) or
      not isinstance(name, str)):
    raise MsgpackError(f'an ndarray header of shape {shape!r}, dtype '
                       f'{name!r}')
  bfloat16 = name == 'bfloat16'
  try:
    dtype = np.dtype(np.int16 if bfloat16 else name)
  except TypeError as e:
    raise MsgpackError(f'unknown dtype {name!r}') from e
  if dtype.hasobject or len(data) != dtype.itemsize * int(np.prod(shape)):
    raise MsgpackError(f'{len(data)} bytes for a {name} array of shape '
                       f'{tuple(shape)}')
  array = np.frombuffer(data, dtype=dtype).reshape(shape)
  if bfloat16:
    return torch.from_numpy(array.copy()).view(torch.bfloat16)
  return array


def _unchunk(node: Dict[str, Any]):
  """flax `_unchunk`: {'shape': {'0': ...}, 'chunks': {'0': ...}} -> one
  array."""
  try:
    shape = tuple(node['shape'][str(i)] for i in range(len(node['shape'])))
    chunks = [node['chunks'][str(i)] for i in range(len(node['chunks']))]
  except (KeyError, TypeError) as e:
    raise MsgpackError(f'a malformed chunked array: {e!r}') from e
  if all(isinstance(c, torch.Tensor) for c in chunks):
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
  return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(
      shape)


def _unchunk_tree(node: Any) -> Any:
  if not isinstance(node, dict):
    return node
  if _CHUNKED in node:
    return _unchunk(node)
  return {k: _unchunk_tree(v) for k, v in node.items()}


def unpackb(data) -> Any:
  """One msgpack object from `data` (bytes-like), ext records decoded."""
  reader = _Reader(memoryview(data).cast('B'))
  value = reader.read()
  if not reader.at_end():
    raise MsgpackError(f'{len(reader._data) - reader._pos} trailing bytes '
                       'after the msgpack object')
  return value


def restore(data) -> Any:
  """flax.serialization.msgpack_restore: the tree, chunked arrays joined."""
  return _unchunk_tree(unpackb(data))


# ---- writing ------------------------------------------------------------------


def _header(out: bytearray, n: int, fix: int, fix_limit: int,
            codes) -> None:
  """A length header: fix|n below fix_limit, else the smallest of the 8-,
  16- and 32-bit forms `codes` offers (None where the type has none)."""
  if fix is not None and n < fix_limit:
    out.append(fix | n)
    return
  for code, size in zip(codes, (1, 2, 4)):
    if code is not None and n < 1 << (8 * size):
      out.append(code)
      out += n.to_bytes(size, 'big')
      return
  raise ValueError(f'length {n} does not fit msgpack')


def _pack_int(out: bytearray, n: int) -> None:
  """msgpack-python's choice: the smallest form that holds n."""
  if 0 <= n < 0x80:
    out.append(n)
  elif -32 <= n < 0:
    out.append(n & 0xff)
  elif n >= 0:
    for code, size in ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)):
      if n < 1 << (8 * size):
        out.append(code)
        out += n.to_bytes(size, 'big')
        return
    raise ValueError(f'int {n} does not fit msgpack')
  else:
    for code, size in ((0xd0, 1), (0xd1, 2), (0xd2, 4), (0xd3, 8)):
      if n >= -(1 << (8 * size - 1)):
        out.append(code)
        out += n.to_bytes(size, 'big', signed=True)
        return
    raise ValueError(f'int {n} does not fit msgpack')


def _pack_str(out: bytearray, s: str) -> None:
  raw = s.encode('utf-8')
  _header(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
  out += raw


def _pack_bin(out: bytearray, raw) -> None:
  raw = memoryview(raw).cast('B')
  _header(out, len(raw), None, 0, (0xc4, 0xc5, 0xc6))
  out += raw


def _ndarray_payload(array) -> bytes:
  """flax `_ndarray_to_bytes`: msgpack (shape, dtype name, C-order
  bytes); a bfloat16 tensor is named 'bfloat16' over its 16-bit words."""
  if isinstance(array, torch.Tensor):
    array = array.detach().cpu()
    if array.dtype == torch.bfloat16:
      name, array = 'bfloat16', array.contiguous().view(torch.int16).numpy()
    else:
      array = array.numpy()
      name = array.dtype.name
  else:
    name = array.dtype.name
  if array.dtype.hasobject or array.dtype.isalignedstruct:
    raise ValueError('object and structured dtypes are not serialized')
  out = bytearray()
  _header(out, 3, 0x90, 16, (None, 0xdc, 0xdd))
  _header(out, array.ndim, 0x90, 16, (None, 0xdc, 0xdd))
  for dim in array.shape:
    _pack_int(out, int(dim))
  _pack_str(out, name)
  _pack_bin(out, np.ascontiguousarray(array).reshape(-1).view(np.uint8))
  return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
  n = len(payload)
  fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
  if n in fixed:
    out.append(fixed[n])
  else:
    _header(out, n, None, 0, (0xc7, 0xc8, 0xc9))
  out += code.to_bytes(1, 'big', signed=True)
  out += payload


def _pack(out: bytearray, value: Any) -> None:
  # bool before int: bool is a subclass of int.
  if value is None:
    out.append(0xc0)
  elif value is True or value is False:
    out.append(0xc3 if value else 0xc2)
  elif isinstance(value, (np.ndarray, torch.Tensor)):
    _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(value))
  elif isinstance(value, np.generic):
    _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(value)))
  elif type(value) is int:
    _pack_int(out, value)
  elif type(value) is float:
    out.append(0xcb)
    out += struct.pack('>d', value)
  elif type(value) is str:
    _pack_str(out, value)
  elif type(value) is bytes:
    _pack_bin(out, value)
  elif type(value) is list:
    _header(out, len(value), 0x90, 16, (None, 0xdc, 0xdd))
    for item in value:
      _pack(out, item)
  elif type(value) is dict:
    _header(out, len(value), 0x80, 16, (None, 0xde, 0xdf))
    for key, item in value.items():
      if type(key) is not str:
        raise TypeError(f'map key {key!r}: flax writes string keys only')
      _pack_str(out, key)
      _pack(out, item)
  else:
    raise TypeError(f'cannot serialize {type(value).__name__}')


def _chunk(array) -> Dict[str, Any]:
  """flax `_chunk`: a flat array cut into chunks of MAX_CHUNK_SIZE bytes."""
  itemsize = array.element_size() if isinstance(array, torch.Tensor) else (
      array.dtype.itemsize)
  size = max(1, int(MAX_CHUNK_SIZE / itemsize))
  flat = array.reshape(-1)
  n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
  return {_CHUNKED: True,
          'shape': {str(i): int(d) for i, d in enumerate(array.shape)},
          'chunks': {str(i): flat[start:start + size]
                     for i, start in enumerate(range(0, n, size))}}


def _chunk_tree(node: Any) -> Any:
  # Keys sorted, as JAX's tree functions leave a dict before flax packs it.
  if isinstance(node, dict):
    return {k: _chunk_tree(node[k]) for k in sorted(node)}
  if isinstance(node, np.ndarray) and node.nbytes > MAX_CHUNK_SIZE:
    return _chunk(node)
  if isinstance(node, torch.Tensor) and (
      node.numel() * node.element_size() > MAX_CHUNK_SIZE):
    return _chunk(node)
  return node


def serialize(tree: Any) -> bytes:
  """flax.serialization.msgpack_serialize: map keys sorted, leaves over
  MAX_CHUNK_SIZE bytes chunked, then packed."""
  out = bytearray()
  _pack(out, _chunk_tree(tree))
  return bytes(out)
