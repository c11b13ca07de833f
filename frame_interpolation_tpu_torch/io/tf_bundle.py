"""TensorFlow's tensor bundle (its checkpoint format), read without TF.

A TF2 checkpoint `<prefix>` (`tf.train.Checkpoint.save`, and a
SavedModel's `variables/variables`) is two kinds of file:

  * `<prefix>.index`: a LevelDB-style table, sorted keys to values. Its
    last 48 bytes are the footer: the block handles (varint64 offset and
    size) of the metaindex and index blocks, zero padding, and the magic
    0xdb4775248b80fb57. The index block maps the last key of each data
    block to that block's handle. A block is its entries, each (varint32
    shared prefix length, varint32 rest length, varint32 value length,
    the rest of the key, the value), then uint32 restart offsets and
    their count, then a 5-byte trailer: the compression type (0: none;
    TF writes no other into a bundle) and the masked CRC32C of the
    block and that type byte.
  * `<prefix>.data-<shard>-of-<N>`: the tensors' bytes, little-endian,
    C order.

The key "" holds a BundleHeaderProto (num_shards = 1, endianness = 2,
0 for little). Every other key holds a BundleEntryProto: dtype = 1, shape
= 2 (TensorShapeProto: dim = 2, each Dim's size = 1), shard_id = 3,
offset = 4, size = 5 and crc32c = 6, the masked CRC32C (TFRecord's mask)
of the entry's bytes. A string tensor's bytes are the varint64 length of
each element, a 4-byte masked CRC32C of those lengths (each as a
little-endian uint32), then the elements; its crc32c covers the lengths
(as uint32), the 4 checksum bytes and the elements.

An object-based checkpoint also holds `_CHECKPOINTABLE_OBJECT_GRAPH`, a
string scalar holding a TrackableObjectGraph: nodes = 1, each with
attributes = 2, each a SerializedTensor (name = 1, full_name = 2,
checkpoint_key = 3). `object_graph` reads those pairs with a protobuf
decoder of a few lines, so nothing here needs TensorFlow or protobuf.

The CRCs go through data/tfrecord.masked_crc32c: the native library where
it builds, else the Python loop.
"""
from __future__ import annotations

import codecs
import os
import re
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..data import tfrecord

MAGIC = 0xdb4775248b80fb57
FOOTER_SIZE = 48
BLOCK_TRAILER_SIZE = 5
OBJECT_GRAPH_KEY = '_CHECKPOINTABLE_OBJECT_GRAPH'

# TF's DataType enum values this reader decodes.
DT_FLOAT, DT_INT32, DT_STRING, DT_INT64, DT_BFLOAT16, DT_HALF = (
    1, 3, 7, 9, 14, 19)
_NUMPY = {DT_FLOAT: np.dtype('<f4'), DT_INT32: np.dtype('<i4'),
          DT_INT64: np.dtype('<i8'), DT_BFLOAT16: np.dtype('<u2'),
          DT_HALF: np.dtype('<f2')}
_DTYPE_NAMES = {DT_FLOAT: 'float32', DT_INT32: 'int32', DT_STRING: 'string',
                DT_INT64: 'int64', DT_BFLOAT16: 'bfloat16',
                DT_HALF: 'float16'}


class BundleError(ValueError):
  """The files are not a tensor bundle this reader can decode, or a
  checksum does not match."""


class Entry(NamedTuple):
  """One tensor's BundleEntryProto."""
  dtype: int
  shape: Tuple[int, ...]
  shard: int
  offset: int
  size: int
  crc32c: int


# ---- protobuf wire format ----------------------------------------------------


def _varint(data: bytes, pos: int) -> Tuple[int, int]:
  """(value, position after it) of the varint at `pos`."""
  value = shift = 0
  while True:
    if pos >= len(data):
      raise BundleError('truncated varint')
    byte = data[pos]
    pos += 1
    value |= (byte & 0x7F) << shift
    if byte < 0x80:
      return value, pos
    shift += 7


def _proto_fields(data: bytes) -> Iterator[Tuple[int, int]]:
  """(field number, value) of each field of a protobuf message: an int
  for varint and fixed fields, bytes for length-delimited ones."""
  pos = 0
  while pos < len(data):
    tag, pos = _varint(data, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:
      value, pos = _varint(data, pos)
    elif wire == 1 or wire == 5:
      width = 8 if wire == 1 else 4
      if pos + width > len(data):
        raise BundleError('truncated fixed field')
      value = int.from_bytes(data[pos:pos + width], 'little')
      pos += width
    elif wire == 2:
      length, pos = _varint(data, pos)
      if pos + length > len(data):
        raise BundleError('truncated length-delimited field')
      value = bytes(data[pos:pos + length])
      pos += length
    else:
      raise BundleError(f'unsupported protobuf wire type {wire}')
    yield field, value


def _entry(value: bytes) -> Entry:
  fields = {1: 0, 3: 0, 4: 0, 5: 0, 6: 0}
  dims: List[int] = []
  for field, v in _proto_fields(value):
    if field == 2:  # TensorShapeProto
      dims += [dict(_proto_fields(dim)).get(1, 0)
               for shape_field, dim in _proto_fields(v) if shape_field == 2]
    elif field == 7:
      raise BundleError('partitioned (sliced) tensors are not supported')
    elif field in fields:
      fields[field] = v
  return Entry(fields[1], tuple(dims), fields[3], fields[4], fields[5],
               fields[6])


# ---- the table ---------------------------------------------------------------


def _block(data: bytes, offset: int, size: int, where: str) -> bytes:
  """A block's contents, after its trailer's checks."""
  end = offset + size
  if end + BLOCK_TRAILER_SIZE > len(data):
    raise BundleError(f'{where}: block at {offset} runs past the end')
  kind = data[end]
  (crc,) = struct.unpack_from('<I', data, end + 1)
  if tfrecord.masked_crc32c(data[offset:end + 1]) != crc:
    raise BundleError(f'{where}: checksum mismatch in the block at {offset}')
  if kind != 0:
    name = 'snappy' if kind == 1 else f'type {kind}'
    raise BundleError(f'{where}: the block at {offset} is {name}-compressed;'
                      ' only uncompressed tables are read')
  return data[offset:end]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
  """(key, value) of each entry of a table block, prefixes expanded."""
  if len(block) < 4:
    raise BundleError('block too short for its restart count')
  (restarts,) = struct.unpack_from('<I', block, len(block) - 4)
  limit = len(block) - 4 - 4 * restarts
  if limit < 0:
    raise BundleError('block too short for its restart array')
  pos, key = 0, b''
  while pos < limit:
    shared, pos = _varint(block, pos)
    rest, pos = _varint(block, pos)
    length, pos = _varint(block, pos)
    if shared > len(key) or pos + rest + length > limit:
      raise BundleError('malformed block entry')
    key = key[:shared] + block[pos:pos + rest]
    pos += rest
    yield key, block[pos:pos + length]
    pos += length


def _handle(value: bytes, pos: int = 0) -> Tuple[int, int, int]:
  offset, pos = _varint(value, pos)
  size, pos = _varint(value, pos)
  return offset, size, pos


def index_handles(data: bytes, where: str = 'table') -> List[Tuple[int, int]]:
  """(offset, size) of each data block of a table, from its footer and
  index block."""
  if len(data) < FOOTER_SIZE:
    raise BundleError(f'{where}: shorter than the 48-byte footer')
  footer = data[-FOOTER_SIZE:]
  (magic,) = struct.unpack_from('<Q', footer, FOOTER_SIZE - 8)
  if magic != MAGIC:
    raise BundleError(f'{where}: bad magic {magic:#018x}, not a TF table')
  _, _, pos = _handle(footer)  # the metaindex block: nothing in it is read
  index_offset, index_size, _ = _handle(footer, pos)
  index = _block(data, index_offset, index_size, where)
  return [_handle(value)[:2] for _, value in _block_entries(index)]


# ---- the bundle --------------------------------------------------------------


def data_path(prefix: str, shard: int, num_shards: int) -> str:
  return f'{prefix}.data-{shard:05d}-of-{num_shards:05d}'


class BundleReader:
  """The entries of the bundle at `prefix`; tensors are read on demand."""

  def __init__(self, prefix: str):
    self.prefix = prefix
    index_path = prefix + '.index'
    with open(index_path, 'rb') as f:
      data = f.read()
    header: Optional[bytes] = None
    self._entries: Dict[str, Entry] = {}
    for offset, size in index_handles(data, index_path):
      for key, value in _block_entries(_block(data, offset, size,
                                             index_path)):
        if key == b'':
          header = value
        else:
          self._entries[key.decode('utf-8')] = _entry(value)
    if header is None:
      raise BundleError(f'{index_path}: no bundle header')
    fields = dict(_proto_fields(header))
    self.num_shards = fields.get(1, 0)
    if fields.get(2, 0) != 0:
      raise BundleError(f'{index_path}: big-endian bundles are not read')
    for key, entry in self._entries.items():
      if not 0 <= entry.shard < self.num_shards:
        raise BundleError(f'{key}: shard {entry.shard} of '
                          f'{self.num_shards}')

  def keys(self) -> List[str]:
    return sorted(self._entries)

  def __contains__(self, key: str) -> bool:
    return key in self._entries

  def entry(self, key: str) -> Entry:
    if key not in self._entries:
      raise KeyError(f'{key} is not in the bundle {self.prefix}')
    return self._entries[key]

  def shape(self, key: str) -> Tuple[int, ...]:
    return self.entry(key).shape

  def dtype(self, key: str) -> str:
    """The entry's dtype by TF's name ('float32', 'bfloat16', ...), or
    'DT_<n>' for one this reader does not decode."""
    code = self.entry(key).dtype
    return _DTYPE_NAMES.get(code, f'DT_{code}')

  def read(self, key: str) -> np.ndarray:
    """The tensor under `key` as a numpy array (bfloat16 as float32,
    strings as an object array of bytes), its checksum verified."""
    entry = self.entry(key)
    if entry.dtype not in _NUMPY and entry.dtype != DT_STRING:
      raise BundleError(f'{key}: unsupported dtype {self.dtype(key)}')
    path = data_path(self.prefix, entry.shard, self.num_shards)
    raw = np.fromfile(path, dtype=np.uint8, count=entry.size,
                      offset=entry.offset)
    if raw.size != entry.size:
      raise BundleError(f'{key}: {path} ends {entry.size - raw.size} bytes '
                        'short of the entry')
    if entry.dtype == DT_STRING:
      return self._strings(key, entry, raw.tobytes())
    if tfrecord.masked_crc32c(raw) != entry.crc32c:
      raise BundleError(f'{key}: checksum mismatch in {path}')
    dtype = _NUMPY[entry.dtype]
    count = int(np.prod(entry.shape, dtype=np.int64))
    if count * dtype.itemsize != entry.size:
      raise BundleError(f'{key}: {entry.size} bytes for shape '
                        f'{entry.shape} of {self.dtype(key)}')
    array = raw.view(dtype).reshape(entry.shape)
    if entry.dtype == DT_BFLOAT16:
      return (array.astype(np.uint32) << 16).view(np.float32)
    return array.astype(dtype.newbyteorder('='), copy=False)

  def _strings(self, key: str, entry: Entry, raw: bytes) -> np.ndarray:
    count = int(np.prod(entry.shape, dtype=np.int64))
    lengths, pos = [], 0
    for _ in range(count):
      length, pos = _varint(raw, pos)
      lengths.append(length)
    sizes = b''.join(struct.pack('<I' if n <= 0xFFFFFFFF else '<Q', n)
                     for n in lengths)
    checksum = raw[pos:pos + 4]
    if (len(checksum) != 4 or struct.unpack('<I', checksum)[0] !=
        tfrecord.masked_crc32c(sizes)):
      raise BundleError(f'{key}: checksum mismatch in the string lengths')
    pos += 4
    if pos + sum(lengths) != len(raw):
      raise BundleError(f'{key}: string lengths do not fill the entry')
    if tfrecord.masked_crc32c(sizes + raw[pos - 4:]) != entry.crc32c:
      raise BundleError(f'{key}: checksum mismatch in the strings')
    values = []
    for length in lengths:
      values.append(raw[pos:pos + length])
      pos += length
    array = np.empty(count, dtype=object)
    array[:] = values
    return array.reshape(entry.shape)


def object_graph(reader: BundleReader) -> List[Tuple[str, str]]:
  """(full_name, checkpoint_key) of every attribute of every node of the
  bundle's TrackableObjectGraph, in node order."""
  if OBJECT_GRAPH_KEY not in reader:
    raise BundleError(f'{reader.prefix}: no {OBJECT_GRAPH_KEY} entry; not '
                      'an object-based checkpoint')
  graph = reader.read(OBJECT_GRAPH_KEY)
  if graph.shape != ():
    raise BundleError(f'{OBJECT_GRAPH_KEY} is not a string scalar')
  pairs = []
  for field, node in _proto_fields(graph.item()):
    if field != 1:
      continue
    for node_field, attribute in _proto_fields(node):
      if node_field == 2:
        names = dict(_proto_fields(attribute))
        pairs.append((names.get(2, b'').decode('utf-8'),
                      names.get(3, b'').decode('utf-8')))
  return pairs


_CHECKPOINT_PATH_RE = re.compile(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                                 re.MULTILINE)


def latest_checkpoint(directory: str) -> Optional[str]:
  """The prefix that `<directory>/checkpoint` names (relative to the
  directory unless absolute), as tf.train.latest_checkpoint; None where
  there is no state file or its prefix has no index."""
  state = os.path.join(directory, 'checkpoint')
  if not os.path.isfile(state):
    return None
  with open(state, 'rb') as f:
    text = f.read().decode('utf-8', errors='surrogateescape')
  match = _CHECKPOINT_PATH_RE.search(text)
  if match is None:
    return None
  path = codecs.escape_decode(match.group(1).encode(
      'utf-8', errors='surrogateescape'))[0].decode('utf-8')
  if not os.path.isabs(path):
    path = os.path.join(directory, path)
  return path if os.path.isfile(path + '.index') else None
