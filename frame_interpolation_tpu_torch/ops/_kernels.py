"""Builds the port's CUDA kernels at first use and counts their launches.

The kernels are CUDA C++ for Hopper (`sm_90a`) in the package's `csrc/`
directory. They expose a plain C interface: raw pointers, ints and the
stream, each function returning `cudaGetLastError()`. So no source
includes PyTorch's headers and a build takes seconds. `library()` compiles
every `csrc/*.cu` with its own `nvcc`, all started together, and links the
objects into one shared library under `_build/` (named by a hash of the
sources and flags, so an edited source rebuilds), loaded with ctypes.

`LAUNCHES` counts kernel launches by the TPU kernel each launch stands in
for. A wrapper adds one (`count_launch`) where it launches its kernel, and
nowhere else, so a run can show that its main path went through the
kernels. The shards of the sharded paths (parallel/) launch from threads
of their own: the build and the counts each take a lock, so shards
neither build twice nor lose counts.

A CUDA graph (utils/programs.py) launches its kernels without calling the
wrappers again. So while a graph is captured, the launches made onto its
capturing stream go into a record (`recording`) and not into `LAUNCHES`,
since a capture launches nothing; each replay then adds the record once
(`add_replay`). The record is keyed by the stream rather than the thread,
because autograd runs a captured backward from a thread of its own, on
the forward's stream. `launch_counts()` thus reads the same for a
replayed call as for an eager one.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional

import torch

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / 'csrc'
BUILD_DIR = _PACKAGE_DIR / '_build'
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = (*ARCH_FLAGS, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

# warp: ops/warp_window.py's window warp (B1); warp_planes: the same kernel
# in its emit_planes mode (B4); splat: ops/warp_splat.py's two splat
# kernels (B5, B6); conv3x3_c64: the C=64 stack of ops/conv_stack.py (B2);
# conv3x3_wide: the C>=128 flat stack of ops/conv_stack_wide.py (B3);
# warp_rows: the window warp on a slab of output rows, as
# backward_warp_window_rows runs it (B1-rows). All names in the JAX
# package.
LAUNCHES: Dict[str, int] = {'warp': 0, 'warp_planes': 0, 'splat': 0,
                            'conv3x3_c64': 0, 'conv3x3_wide': 0,
                            'warp_rows': 0}

# Filled by the first library() call: 'path', 'seconds' (0.0 when the
# library was already built) and 'log' (nvcc's -Xptxas -v report).
BUILD_INFO: Dict[str, object] = {}

_lib = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# Capturing stream (its handle) -> the launches its capture records.
_RECORDS: Dict[int, Dict[str, int]] = {}


def count_launch(name: str, stream: Optional[int] = None) -> None:
  """Adds one launch of `name`, made onto `stream` (a handle, as
  `stream_of` gives it): to the record of that stream's capture while
  one is recorded, else to `LAUNCHES`. Safe from several threads."""
  with _COUNT_LOCK:
    counts = _RECORDS.get(stream, LAUNCHES) if _RECORDS else LAUNCHES
    counts[name] += 1


@contextlib.contextmanager
def recording(stream: int) -> Iterator[Dict[str, int]]:
  """Records the launches made onto `stream` (a capturing stream's
  handle) while the context is open; yields the record."""
  record = dict.fromkeys(LAUNCHES, 0)
  with _COUNT_LOCK:
    if stream in _RECORDS:
      raise RuntimeError(f'stream {stream:#x} is already being recorded')
    _RECORDS[stream] = record
  try:
    yield record
  finally:
    with _COUNT_LOCK:
      del _RECORDS[stream]


def add_replay(record: Mapping[str, int]) -> None:
  """Adds a recorded capture's launches once: one replay of its graph."""
  with _COUNT_LOCK:
    for name, count in record.items():
      LAUNCHES[name] += count


def reset_launch_counts() -> None:
  with _COUNT_LOCK:
    for name in LAUNCHES:
      LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
  with _COUNT_LOCK:
    return dict(LAUNCHES)


def _nvcc() -> str:
  for home in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH'),
               '/usr/local/cuda'):
    if home and (Path(home) / 'bin' / 'nvcc').is_file():
      return str(Path(home) / 'bin' / 'nvcc')
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME).')
  return found


def _build() -> Path:
  sources = sorted(CSRC_DIR.glob('*.cu'))
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for path in sorted(CSRC_DIR.glob('*.cu*')):
    digest.update(path.name.encode())
    digest.update(path.read_bytes())
  target = BUILD_DIR / f'libfi_kernels_{digest.hexdigest()[:16]}.so'
  BUILD_INFO['path'] = str(target)
  if target.is_file():
    BUILD_INFO.update(seconds=0.0, log='')
    return target
  nvcc = _nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  partial = target.with_name(f'{target.name}.{os.getpid()}.tmp')
  start = time.perf_counter()
  # One nvcc per source, all running at once; then one link.
  jobs = []
  for source in sources:
    obj = partial.with_name(f'{partial.name}.{source.stem}.o')
    cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(source)]
    jobs.append((cmd, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  log, failed = [], []
  for cmd, _, proc in jobs:
    out, _ = proc.communicate()
    log.append(out)
    if proc.returncode != 0:
      failed.append(f'nvcc failed with code {proc.returncode}:\n'
                    f'{" ".join(cmd)}\n{out}')
  objects = [str(obj) for _, obj, _ in jobs]
  if not failed:
    cmd = [nvcc, *ARCH_FLAGS, '-shared', '-o', str(partial), *objects]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    log.append(proc.stdout + proc.stderr)
    if proc.returncode != 0:
      failed.append(f'link failed with code {proc.returncode}:\n'
                    f'{" ".join(cmd)}\n{proc.stdout}\n{proc.stderr}')
  for obj in objects:
    if os.path.exists(obj):
      os.remove(obj)
  if failed:
    raise RuntimeError('\n'.join(failed))
  os.replace(partial, target)
  BUILD_INFO.update(seconds=time.perf_counter() - start, log=''.join(log))
  return target


def _declare(lib: ctypes.CDLL) -> None:
  ptr, i32 = ctypes.c_void_p, ctypes.c_int
  for name in ('fi_warp_bf16', 'fi_warp_f32'):
    fn = getattr(lib, name)
    # image, flow, out, B, H, W, C, stream
    fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = i32
  for name in ('fi_warp_rows_bf16', 'fi_warp_rows_f32'):
    fn = getattr(lib, name)
    # slabs (a host array of n_slabs device pointers, each slab (B,
    # slab_rows, W, C)), n_slabs, slab_rows, flow (B, H_out rows from
    # global row row_offset), out, B, H_out, W, C, row_offset, clamp_h,
    # stream
    fn.argtypes = [ctypes.POINTER(ptr), i32, i32, ptr, ptr, i32, i32, i32,
                   i32, i32, i32, ptr]
    fn.restype = i32
  for name in ('fi_warp_planes_bf16', 'fi_warp_planes_f32'):
    fn = getattr(lib, name)
    # image, flow, du, dv, B, H, W, C, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = i32
  for name in ('fi_splat_fixed_bf16', 'fi_splat_fixed_f32'):
    fn = getattr(lib, name)
    # g, flow, acc (f32), workspace, B, H, W, C, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    fn.restype = i32
  # B, H, W -> the splat's workspace in bytes
  lib.fi_splat_fixed_workspace_bytes.argtypes = [i32, i32, i32]
  lib.fi_splat_fixed_workspace_bytes.restype = ctypes.c_longlong
  for name in ('fi_conv3x3_bf16', 'fi_conv3x3_tf32'):
    fn = getattr(lib, name)
    # x, w, bias, out, pool (or NULL), N, H, W, Cin, Cout, slope, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                   ctypes.c_float, ptr]
    fn.restype = i32
  # N, H, W, Cin, Cout -> the parts fi_conv3x3_f32 splits K into (1: none)
  lib.fi_conv3x3_f32_splits.argtypes = [i32, i32, i32, i32, i32]
  lib.fi_conv3x3_f32_splits.restype = i32
  # x, w, bias, out, pool (or NULL), part (splits * N*H*W*Cout f32, or NULL
  # for 1 split), splits, N, H, W, Cin, Cout, slope, stream
  lib.fi_conv3x3_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                 i32, i32, i32, ctypes.c_float, ptr]
  lib.fi_conv3x3_f32.restype = i32
  lib.fi_error_string.argtypes = [i32]
  lib.fi_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
  """The kernels' shared library, built and loaded on first call (once,
  whichever thread calls first; the others wait for it)."""
  global _lib
  with _LIB_LOCK:
    if _lib is None:
      lib = ctypes.CDLL(str(_build()))
      _declare(lib)
      _lib = lib
  return _lib


def require_cuda(name: str, *tensors: torch.Tensor,
                 alignment: int = 1) -> None:
  """Raises unless every tensor is a contiguous CUDA tensor whose data
  starts on an `alignment`-byte boundary."""
  for t in tensors:
    if t.device.type != 'cuda':
      raise ValueError(f'{name}: the kernel takes CUDA tensors; got one on '
                       f'{t.device}')
    if not t.is_contiguous():
      raise ValueError(f'{name}: the kernel takes contiguous tensors')
    if t.data_ptr() % alignment:
      raise ValueError(f'{name}: the kernel takes tensors aligned to '
                       f'{alignment} bytes')


def stream_of(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, code: int) -> None:
  """Raises if a kernel's C entry point reported a CUDA error."""
  if code != 0:
    message = library().fi_error_string(code).decode()
    raise RuntimeError(f'{name}: CUDA error {code} ({message})')
