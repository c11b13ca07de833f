"""Self-contained TFRecord reader/writer (no TensorFlow dependency).

Port of frame_interpolation_tpu/data/tfrecord.py: the on-disk format of
the reference's datasets
(training/data_lib.py:170-209 in google-research/frame-interpolation),

  record := uint64 length (LE) | uint32 masked_crc32c(length) |
            bytes data[length] | uint32 masked_crc32c(data)
  masked_crc(x) = ((crc(x) >> 15 | crc(x) << 17) + 0xa282ead8) & 0xffffffff

with crc the CRC32C (Castagnoli).

The CRC is the native library's slicing-by-8 loop (native/, built with
the host's C compiler at first use) where it builds, else a table-driven
Python loop, as the JAX package falls back; `crc_backend()` says which.
The writer checksums every record with it, and `read_records` with
`validate=True` scans a memory map of the file in C. Readers skip the CRC
with `validate=False` (the training and eval pipelines do), which reads in
Python and never builds the library. Sharded names follow the reference:
'<name>@N' expands to '<name>-0000i-of-0000N'.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional

from .. import native

_CRC_POLY = 0x82F63B78  # reversed Castagnoli polynomial
_MASK_DELTA = 0xA282EAD8


def _make_table() -> List[int]:
  table = []
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
    table.append(crc)
  return table


_TABLE = _make_table()


def crc_backend() -> str:
  """'native' where the C library builds or is built here, else 'python'
  (the first call may build it)."""
  return 'native' if native.available() else 'python'


def python_crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of `data`, a byte at a time in Python."""
  crc = 0xFFFFFFFF
  table = _TABLE
  for byte in data:
    crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
  return crc ^ 0xFFFFFFFF


def python_masked_crc32c(data: bytes) -> int:
  crc = python_crc32c(data)
  return ((crc >> 15 | crc << 17) + _MASK_DELTA) & 0xFFFFFFFF


def crc32c(data: bytes) -> int:
  """CRC32C (Castagnoli) of `data`."""
  if native.available():
    return native.crc32c(data)
  return python_crc32c(data)


def masked_crc32c(data: bytes) -> int:
  """The TFRecord-masked CRC32C of `data` (also TF's checkpoint
  checksum), natively where the library builds."""
  if native.available():
    return native.masked_crc32c(data)
  return python_masked_crc32c(data)


class TFRecordWriter:
  """Writes TFRecord files TensorFlow can read."""

  def __init__(self, path: str):
    directory = os.path.dirname(path)
    if directory:
      os.makedirs(directory, exist_ok=True)
    self._file = open(path, 'wb')

  def write(self, record: bytes) -> None:
    length = struct.pack('<Q', len(record))
    self._file.write(length)
    self._file.write(struct.pack('<I', masked_crc32c(length)))
    self._file.write(record)
    self._file.write(struct.pack('<I', masked_crc32c(record)))

  def flush(self) -> None:
    self._file.flush()

  def close(self) -> None:
    self._file.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_records(path: str, validate: bool = True) -> Iterator[bytes]:
  """Yields raw record payloads from a TFRecord file."""
  if validate and native.available():
    yield from _read_records_native(path)
    return
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if not header:
        return
      if len(header) < 12:
        raise IOError(f'{path}: truncated record header')
      (length,) = struct.unpack('<Q', header[:8])
      (length_crc,) = struct.unpack('<I', header[8:12])
      if validate and masked_crc32c(header[:8]) != length_crc:
        raise IOError(f'{path}: corrupted record length CRC')
      data = f.read(length)
      if len(data) < length:
        raise IOError(f'{path}: truncated record body')
      footer = f.read(4)
      if len(footer) < 4:
        raise IOError(f'{path}: truncated record CRC')
      (data_crc,) = struct.unpack('<I', footer)
      if validate and masked_crc32c(data) != data_crc:
        raise IOError(f'{path}: corrupted record data CRC')
      yield data


def _read_records_native(path: str) -> Iterator[bytes]:
  """read_records(validate=True) by one C pass over a memory map of the
  file, which checks every CRC before the first record is yielded."""
  with open(path, 'rb') as f:
    if os.fstat(f.fileno()).st_size == 0:
      return
    with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mapped:
      try:
        frames = native.scan_tfrecord(mapped, validate=True)
      except IOError as e:
        raise IOError(f'{path}: {e}') from None
      for offset, length in frames:
        yield mapped[offset:offset + length]


def sharded_filenames(spec: str) -> List[str]:
  """Expands '<name>@N' to the reference's '-0000i-of-0000N' shard names.

  A spec without '@' (or with a non-integer suffix) is returned as-is
  (training/data_lib.py:170-183 semantics).
  """
  if '@' not in spec:
    return [spec]
  base, _, count = spec.rpartition('@')
  if not count.isdigit():
    return [spec]
  n = int(count)
  return [shard_filename(base, i, n) for i in range(n)]


def shard_filename(base: str, index: int, total: int) -> str:
  return f'{base}-{index:05d}-of-{total:05d}'


def read_sharded(spec: str, validate: bool = True,
                 max_records: Optional[int] = None) -> Iterator[bytes]:
  """Reads records across all shards of a '<name>@N' spec, in shard order."""
  count = 0
  for path in sharded_filenames(spec):
    for record in read_records(path, validate=validate):
      if max_records is not None and count >= max_records:
        return
      count += 1
      yield record
