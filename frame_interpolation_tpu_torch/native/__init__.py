"""Host-side CRC32C and TFRecord framing in C, built at first use.

The port's copy of frame_interpolation_tpu/native: `fi_native.c` (a
slicing-by-8 CRC32C, its TFRecord mask, and a scan of a TFRecord file's
frames) behind a plain C interface, compiled with the host's C compiler
(`$CC`, else `cc`) as `cc -O3 -shared -fPIC` into the package's `_build/`
directory, named by a hash of the source and the flags, and loaded with
ctypes. It needs no Python headers, and ctypes releases the interpreter
lock around each call.

Importing this module compiles nothing: `library()` builds on its first
call. `available()` says whether a library could be built or loaded here;
data/tfrecord.py takes the Python loop where it cannot, as the JAX package
does.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'fi_native.c'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
CFLAGS = ('-O3', '-shared', '-fPIC')

# Filled by the first library() call: 'path' and 'seconds' (0.0 when the
# library was already built).
BUILD_INFO: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None
_LOCK = threading.Lock()


def _compiler() -> str:
  cc = os.environ.get('CC', 'cc')
  found = shutil.which(cc)
  if found is None:
    raise RuntimeError(f'no C compiler: {cc!r} is not on PATH (set CC)')
  return found


def _build() -> Path:
  digest = hashlib.sha256(' '.join(CFLAGS).encode() + SOURCE.read_bytes())
  target = BUILD_DIR / f'libfi_native_{digest.hexdigest()[:16]}.so'
  BUILD_INFO.update(path=str(target), seconds=0.0)
  if target.is_file():
    return target
  start = time.perf_counter()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  partial = target.with_name(f'{target.name}.{os.getpid()}.tmp')
  cmd = [_compiler(), *CFLAGS, '-o', str(partial), str(SOURCE)]
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False,
                        timeout=300)
  if proc.returncode != 0:
    partial.unlink(missing_ok=True)
    raise RuntimeError(f'{" ".join(cmd)} failed with code {proc.returncode}:'
                       f'\n{proc.stdout}{proc.stderr}')
  os.replace(partial, target)
  BUILD_INFO['seconds'] = time.perf_counter() - start
  return target


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
  size_t, ptr, i64 = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int64
  lib.fi_crc32c.argtypes = (ptr, size_t)
  lib.fi_crc32c.restype = ctypes.c_uint32
  lib.fi_masked_crc32c.argtypes = (ptr, size_t)
  lib.fi_masked_crc32c.restype = ctypes.c_uint32
  lib.fi_scan_tfrecord.argtypes = (ptr, size_t, ctypes.c_int, ptr, ptr, i64)
  lib.fi_scan_tfrecord.restype = i64
  return lib


def library() -> ctypes.CDLL:
  """The loaded library, built on the first call; raises RuntimeError
  when it cannot be built."""
  global _lib
  with _LOCK:
    if _lib is None:
      _lib = _declare(ctypes.CDLL(str(_build())))
    return _lib


def available() -> bool:
  """Whether the library builds (or is built) here. A failure is logged
  once and remembered."""
  global _failure
  if _lib is not None:
    return True
  if _failure is not None:
    return False
  try:
    library()
    return True
  except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
    _failure = str(e)
    logging.warning('native CRC unavailable, using the Python loop: %s', e)
    return False


def _buffer(data) -> np.ndarray:
  """A uint8 view of a bytes-like object (bytes, memoryview, mmap); the
  caller keeps it alive while C reads it."""
  return np.frombuffer(data, dtype=np.uint8)


def crc32c(data) -> int:
  """CRC32C (Castagnoli) of a bytes-like object."""
  view = _buffer(data)
  return int(library().fi_crc32c(view.ctypes.data, view.size))


def masked_crc32c(data) -> int:
  """The TFRecord-masked CRC32C of a bytes-like object."""
  view = _buffer(data)
  return int(library().fi_masked_crc32c(view.ctypes.data, view.size))


def scan_tfrecord(data, validate: bool = True) -> List[Tuple[int, int]]:
  """(payload offset, payload length) of every record of an in-memory
  TFRecord file. Raises IOError when the data is truncated or, with
  `validate`, when a CRC does not match."""
  frames = _scan(data, validate)
  # Raised here, where no view of `data` is alive: an mmap cannot close
  # while a traceback holds one.
  if frames is None:
    raise IOError('corrupted or truncated TFRecord data')
  return frames


def _scan(data, validate: bool) -> Optional[List[Tuple[int, int]]]:
  lib, view = library(), _buffer(data)
  # A pass over the headers counts the records, a second fills them in.
  count = lib.fi_scan_tfrecord(view.ctypes.data, view.size, 0, None, None, 0)
  if count < 0:
    return None
  frames = np.empty((2, count), np.int64)
  count = lib.fi_scan_tfrecord(view.ctypes.data, view.size, int(validate),
                               frames[0].ctypes.data, frames[1].ctypes.data,
                               count)
  if count < 0:
    return None
  return list(zip(frames[0].tolist(), frames[1].tolist()))


__all__ = ['available', 'crc32c', 'library', 'masked_crc32c',
           'scan_tfrecord']
