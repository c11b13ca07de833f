"""Minimal tf.train.Example protobuf codec (pure Python, no TF/protobuf dep).

Port of frame_interpolation_tpu/data/example_proto.py, unchanged in what it
reads and writes (the JAX package's tests pin it against TF's codec). The
reference serializes dataset triplets as tf.train.Example protos inside
TFRecords (datasets/util.py:140-168, training/data_lib.py:23-82 in
google-research/frame-interpolation). This implements exactly the subset of
the proto3 wire format those messages use, so the data plane has no
TensorFlow or protobuf runtime dependency:

  Example    { Features features = 1; }
  Features   { map<string, Feature> feature = 1; }
  Feature    { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
                       Int64List int64_list = 3; } }
  BytesList  { repeated bytes value = 1; }
  FloatList  { repeated float value = 1 [packed]; }
  Int64List  { repeated int64 value = 1 [packed]; }

Records written here read the same through the JAX package's codec, and
the other way round (tests/test_torch_data.py).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[int], List[float]]

_WT_VARINT = 0
_WT_LEN = 2
_WT_I32 = 5


def _varint(value: int) -> bytes:
  out = bytearray()
  while True:
    byte = value & 0x7F
    value >>= 7
    if value:
      out.append(byte | 0x80)
    else:
      out.append(byte)
      return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
  return _varint((field << 3) | wire_type)


def _len_delimited(field: int, payload: bytes) -> bytes:
  return _tag(field, _WT_LEN) + _varint(len(payload)) + payload


def _encode_feature(values: FeatureValue) -> bytes:
  if not isinstance(values, (list, tuple)):
    values = [values]
  if len(values) and isinstance(values[0], (bytes, bytearray, str)):
    payload = b''.join(
        _len_delimited(1, v.encode() if isinstance(v, str) else bytes(v))
        for v in values)
    return _len_delimited(1, payload)  # bytes_list
  if len(values) and isinstance(values[0], float):
    packed = struct.pack(f'<{len(values)}f', *values)
    return _len_delimited(2, _len_delimited(1, packed))  # float_list
  # int64_list (also the empty-list default).
  packed = b''.join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
  return _len_delimited(3, _len_delimited(1, packed))


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
  """Serializes {name: values} into a tf.train.Example wire message.

  Features are emitted in sorted name order (deterministic output; TF's map
  serialization order is unspecified, parsers accept any order).
  """
  entries = []
  for name in sorted(features):
    entry = (_len_delimited(1, name.encode()) +        # map key
             _len_delimited(2, _encode_feature(features[name])))  # Feature
    entries.append(_len_delimited(1, entry))  # map entry
  features_msg = b''.join(entries)
  return _len_delimited(1, features_msg)  # Example.features


class _Reader:

  def __init__(self, data: bytes):
    self.data = data
    self.pos = 0

  def eof(self) -> bool:
    return self.pos >= len(self.data)

  def varint(self) -> int:
    result = 0
    shift = 0
    while True:
      byte = self.data[self.pos]
      self.pos += 1
      result |= (byte & 0x7F) << shift
      if not byte & 0x80:
        return result
      shift += 7

  def bytes_(self) -> bytes:
    length = self.varint()
    out = self.data[self.pos:self.pos + length]
    if len(out) < length:
      raise ValueError('truncated protobuf message')
    self.pos += length
    return out

  def skip(self, wire_type: int) -> None:
    if wire_type == _WT_VARINT:
      self.varint()
    elif wire_type == _WT_LEN:
      self.bytes_()
    elif wire_type == _WT_I32:
      self.pos += 4
    elif wire_type == 1:  # 64-bit
      self.pos += 8
    else:
      raise ValueError(f'unsupported wire type {wire_type}')


def _decode_feature(data: bytes) -> FeatureValue:
  reader = _Reader(data)
  while not reader.eof():
    key = reader.varint()
    field, wire_type = key >> 3, key & 7
    if field == 1 and wire_type == _WT_LEN:  # bytes_list
      inner = _Reader(reader.bytes_())
      values: List[bytes] = []
      while not inner.eof():
        ikey = inner.varint()
        if ikey >> 3 == 1 and ikey & 7 == _WT_LEN:
          values.append(inner.bytes_())
        else:
          inner.skip(ikey & 7)
      return values
    elif field == 2 and wire_type == _WT_LEN:  # float_list
      inner = _Reader(reader.bytes_())
      floats: List[float] = []
      while not inner.eof():
        ikey = inner.varint()
        if ikey >> 3 == 1 and ikey & 7 == _WT_LEN:
          packed = inner.bytes_()
          floats.extend(struct.unpack(f'<{len(packed) // 4}f', packed))
        elif ikey >> 3 == 1 and ikey & 7 == _WT_I32:
          floats.append(struct.unpack('<f', inner.data[inner.pos:
                                                       inner.pos + 4])[0])
          inner.pos += 4
        else:
          inner.skip(ikey & 7)
      return floats
    elif field == 3 and wire_type == _WT_LEN:  # int64_list
      inner = _Reader(reader.bytes_())
      ints: List[int] = []
      while not inner.eof():
        ikey = inner.varint()
        if ikey >> 3 == 1 and ikey & 7 == _WT_LEN:
          packed = _Reader(inner.bytes_())
          while not packed.eof():
            value = packed.varint()
            if value >= 1 << 63:
              value -= 1 << 64
            ints.append(value)
        elif ikey >> 3 == 1 and ikey & 7 == _WT_VARINT:
          value = inner.varint()
          if value >= 1 << 63:
            value -= 1 << 64
          ints.append(value)
        else:
          inner.skip(ikey & 7)
      return ints
    else:
      reader.skip(wire_type)
  return []


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
  """Parses a tf.train.Example wire message into {name: values}."""
  reader = _Reader(data)
  features: Dict[str, FeatureValue] = {}
  while not reader.eof():
    key = reader.varint()
    if key >> 3 == 1 and key & 7 == _WT_LEN:  # Example.features
      features_reader = _Reader(reader.bytes_())
      while not features_reader.eof():
        fkey = features_reader.varint()
        if fkey >> 3 == 1 and fkey & 7 == _WT_LEN:  # map entry
          entry = _Reader(features_reader.bytes_())
          name = None
          value: FeatureValue = []
          while not entry.eof():
            ekey = entry.varint()
            if ekey >> 3 == 1 and ekey & 7 == _WT_LEN:
              name = entry.bytes_().decode()
            elif ekey >> 3 == 2 and ekey & 7 == _WT_LEN:
              value = _decode_feature(entry.bytes_())
            else:
              entry.skip(ekey & 7)
          if name is not None:
            features[name] = value
        else:
          features_reader.skip(fkey & 7)
    else:
      reader.skip(key & 7)
  return features
