"""Captured programs: the port's counterpart of `jax.jit` on the card.

The JAX package compiles each entry point into one XLA program,
specialized on its inputs' shapes and dtypes and on its static arguments,
and dispatches it once a call (inference/interpolator.py, the cached tree,
training/train_lib.py's step). PyTorch runs eagerly: every op is a launch
issued from Python, and where a call is thousands of small launches the
host, not the card, sets its time. `Program` captures a function once per
key as a CUDA graph and replays it, one launch from the host a call:

  * the key is the inputs' structure, shapes and dtypes, the static
    keyword arguments, and the process-wide switches that change what the
    function launches (grad and inference mode, cuDNN's and TF32's flags,
    deterministic algorithms);
  * the first call of a key copies the inputs into static buffers, runs
    the function eagerly on a side stream (the warm-up: the kernels'
    build, their attributes, cuDNN's plans, an optimizer's state and every
    lazy constant happen there, outside the capture), and then captures it
    on the same stream; the warm-up's result is that call's result, so a
    function that updates state in place (a train step) runs once a call;
  * a later call copies its inputs into the static buffers, replays the
    graph and returns clones of the static outputs, so a later replay
    never overwrites what an earlier call returned;
  * the launches that a capture records (ops/_kernels.recording) are
    added once a replay, so launch counts read as for the eager calls.

All graphs of one program, and of the programs given one `Pool`, share
a private memory pool: their replays are serialized by the pool's lock
and each replay's outputs are cloned, in stream order, before the next
replay starts (the pool's event), so a graph may reuse blocks that
another freed. The allocator hands a block only to the stream that freed
it, so every program of a pool warms up and captures on the pool's one
stream. And it carves a block only from a free range of one segment: in
fixed segments, each made for the tensor that first needed it, a smaller
graph fits into a larger one's freed blocks but not the other way (on an
H100 80GB, 1080p bf16 pairs captured at batch 1, 2, 3 grew a pool by
32.3 GiB, at 3, 2, 1 by 24.5). So captures allocate expandable segments
(one segment a pool that grows by pages, its freed ranges merging), and
graphs in any order share what the largest of them needs (21.3 GiB for
that set). The allocator
returns a private pool's memory to the device only once no graph uses
it: the pool bounds its graphs by count and by memory. Before a capture
it drops its least recently used graph while it holds `MAX_GRAPHS`, and
every graph once its captures have grown it past `POOL_BUDGET_SHARE` of
the device's memory; a pool that drops every graph returns its memory
and starts afresh. Its memory is thus at most the budget plus the graph
captured last.

Nothing falls back: a capture or replay that fails raises. A program
exists only on a CUDA device; on the CPU the eager function is the path,
and the callers decide (`resolve`).

Under a profiler (utils/profiling.span) a replay is one
`fi.replay.<program>` span (the copies into the static buffers, the
replay, the output clones) and a first call one `fi.capture.<program>`
span (making room, the warm-up, the capture).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional

import torch

from ..ops import _kernels
from . import profiling

# Graphs kept a pool, least recently used dropped first: the bound of the
# JAX package's compile cache (utils/xla_options.py's LRU of 16).
MAX_GRAPHS = 16

# The share of the device's memory that a pool's graphs may hold before
# the next capture drops them all (a 1080p bf16 pair's graph holds 8.2 GiB
# of an 80 GB H100); the rest of the card stays for the weights, eager work
# and the next capture's warm-up.
POOL_BUDGET_SHARE = 0.25

# One capture at a time in the process: shards capture from threads of
# their own, and a capture empties the allocator's cache first; the
# allocator's settings change for the capture's span.
_CAPTURE_LOCK = threading.Lock()

_EXPANDABLE = 'expandable_segments:True'


def _set_allocator(settings: str) -> None:
  setter = getattr(torch._C, '_accelerator_setAllocatorSettings', None)
  if setter is None:
    setter = torch.cuda.memory._set_allocator_settings
  setter(settings)


@contextlib.contextmanager
def expandable_segments():
  """The allocator makes expandable segments while the block runs (a
  capture's, into its private pool), then fixed ones again, unless the
  process asked for expandable segments from its start."""
  conf = ','.join(os.environ.get(name, '') for name in (
      'PYTORCH_CUDA_ALLOC_CONF', 'PYTORCH_ALLOC_CONF'))
  if _EXPANDABLE in conf.replace(' ', ''):
    yield
    return
  _set_allocator(_EXPANDABLE)
  try:
    yield
  finally:
    _set_allocator('expandable_segments:False')


def weak_method(method: Callable[..., Any]) -> Callable[..., Any]:
  """`method`, holding its object weakly: a program of an object's own
  method then keeps no cycle that would hold the object's graphs (and
  their memory) until the garbage collector runs."""
  ref = weakref.WeakMethod(method)
  return lambda *args, **kwargs: ref()(*args, **kwargs)


def resolve(graphs: Optional[bool], device: torch.device, what: str) -> bool:
  """Whether `what` runs as captured programs on `device`: `graphs`, or
  on a CUDA device when it is None. True on a device other than CUDA
  raises: CUDA graphs exist only there."""
  if graphs is None:
    return device.type == 'cuda'
  if graphs and device.type != 'cuda':
    raise ValueError(f'{what}: graphs=True needs a CUDA device; got '
                     f'{device} (on the CPU the eager path is the path)')
  return bool(graphs)


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
  """`fn` on every tensor of nested tuples, lists and dicts; other leaves
  as they are."""
  if isinstance(tree, torch.Tensor):
    return fn(tree)
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, t) for t in tree)
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return tree


def tree_tensors(tree: Any) -> list:
  """The tensors of `tree` in `tree_map`'s order."""
  found = []
  tree_map(found.append, tree)
  return found


def signature(tree: Any) -> Any:
  """A hashable image of `tree`: its structure, each tensor's shape and
  dtype, and every other leaf's value."""
  if isinstance(tree, torch.Tensor):
    return ('tensor', tuple(tree.shape), tree.dtype)
  if isinstance(tree, (tuple, list)):
    return (type(tree).__name__, tuple(signature(t) for t in tree))
  if isinstance(tree, dict):
    return ('dict', tuple((k, signature(v)) for k, v in tree.items()))
  return ('value', tree)


def backend_flags() -> tuple:
  """The switches under which one function launches other kernels."""
  return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
          torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
          torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
          torch.backends.cuda.matmul.allow_tf32,
          torch.get_float32_matmul_precision(),
          torch.are_deterministic_algorithms_enabled())


@dataclasses.dataclass
class Capture:
  """One key's graph, its static buffers, and what its capture cost."""
  graph: Any
  inputs: Any
  outputs: Any
  launches: Dict[str, int]
  capture_seconds: float
  pool_bytes: int


class Pool:
  """A private memory pool on one device, the graphs captured in it (an
  LRU, bounded by `make_room`), and the lock and the event that order
  their replays. The programs given one pool share it; a capture is keyed
  by its program's serial number and the program's own key."""

  def __init__(self):
    self.lock = threading.RLock()
    self.handle = None  # made at the first capture: it needs CUDA
    self.stream = None  # every warm-up and capture runs on it
    self.done = None    # recorded after the last call's reads of the pool
    self.bytes = 0      # the pool's growth over its captures since it was
                        # last emptied: private memory is never returned
                        # while a graph uses the pool
    self.clears = 0     # how often the budget emptied it
    self._captures: 'collections.OrderedDict[Any, Capture]' = (
        collections.OrderedDict())

  def get(self, key: Any) -> Optional[Capture]:
    """The capture of `key`, now the most recently used; None if none."""
    capture = self._captures.get(key)
    if capture is not None:
      self._captures.move_to_end(key)
    return capture

  def add(self, key: Any, capture: Capture) -> None:
    self._captures[key] = capture
    self.bytes += capture.pool_bytes

  def captures(self, serial: int) -> Dict[Any, Capture]:
    """The live captures of program `serial` by its keys, least recently
    used first."""
    return {key[1]: c for key, c in self._captures.items()
            if key[0] == serial}

  def make_room(self, budget: int) -> None:
    """Before a capture: drops the least recently used graph while the
    pool holds MAX_GRAPHS, and every graph once the pool has grown past
    `budget` bytes."""
    while len(self._captures) >= MAX_GRAPHS:
      self._drop(next(iter(self._captures)))
    if self.bytes > budget:
      self.clears += 1
      self.clear()

  def clear(self) -> None:
    """Drops every graph; the pool's memory goes back to the device."""
    while self._captures:
      self._drop(next(iter(self._captures)))
    # The allocator frees a private pool that no graph uses and never
    # shares it again: the next capture starts a new one.
    self.handle = None
    self.bytes = 0
    torch.cuda.empty_cache()

  def _drop(self, key: Any) -> None:
    capture = self._captures.pop(key)
    capture.inputs = capture.outputs = None
    capture.graph.reset()


class Program:
  """`fn(*args, **static)` captured as a CUDA graph per key on `device`.

  `args` are tensors in nested tuples, lists and dicts (on any device:
  they are copied in); `static` are hashable values, part of the key.
  `fn` must be a function of those alone and of state that stays at one
  address (a model's parameters, an optimizer's state): its launches are
  replayed on the buffers they were captured on.
  """

  _serials = itertools.count()

  def __init__(self, fn: Callable[..., Any], device: Any, name: str,
               pool: Optional[Pool] = None):
    self.device = torch.device(device)
    if self.device.type != 'cuda':
      raise ValueError(f'{name}: a captured program needs a CUDA device; '
                       f'got {self.device}')
    if self.device.index is None:
      self.device = torch.device('cuda', torch.cuda.current_device())
    self.name = name
    self._replay_span = f'fi.replay.{name}'
    self._capture_span = f'fi.capture.{name}'
    self.pool = pool or Pool()
    self._fn = fn
    self._serial = next(Program._serials)
    self._budget = int(POOL_BUDGET_SHARE * torch.cuda.get_device_properties(
        self.device).total_memory)

  @property
  def captures(self) -> Dict[Any, Capture]:
    """The live captures by key, least recently used first."""
    return self.pool.captures(self._serial)

  @property
  def pool_bytes(self) -> int:
    """The pool's growth over this program's live captures."""
    return sum(c.pool_bytes for c in self.captures.values())

  def __call__(self, *args: Any, **static: Any) -> Any:
    key = (self._serial, (signature(args), tuple(sorted(static.items())),
                          backend_flags()))
    with self.pool.lock, torch.cuda.device(self.device):
      capture = self.pool.get(key)
      if capture is None:
        return self._first_call(key, args, static)
      return self._replay(capture, args)

  def release(self) -> None:
    """Destroys every graph of this program's pool (those of the other
    programs given it too); its memory goes back to the device."""
    with self.pool.lock:
      self.pool.clear()

  def _first_call(self, key, args, static):
    with profiling.span(self._capture_span):
      pool = self.pool
      pool.make_room(self._budget)
      if pool.stream is None:
        pool.stream = torch.cuda.Stream(self.device)
      if pool.handle is None:
        pool.handle = torch.cuda.graph_pool_handle()
        pool.done = torch.cuda.Event()
      stream = pool.stream
      current = torch.cuda.current_stream(self.device)
      inputs = tree_map(
          lambda t: torch.empty(t.shape, dtype=t.dtype,
                                device=self.device).copy_(t), args)
      # The warm-up: this call's result, computed eagerly.
      stream.wait_stream(current)
      with torch.cuda.stream(stream):
        result = tree_map(torch.clone, self._fn(*inputs, **static))
      current.wait_stream(stream)
      graph = torch.cuda.CUDAGraph()
      start = time.perf_counter()
      with _CAPTURE_LOCK, expandable_segments():
        with torch.cuda.graph(graph, pool=pool.handle, stream=stream,
                              capture_error_mode='thread_local'):
          reserved = torch.cuda.memory_reserved(self.device)
          with _kernels.recording(stream.cuda_stream) as launches:
            outputs = self._fn(*inputs, **static)
          pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
      pool.add(key, Capture(graph=graph, inputs=inputs, outputs=outputs,
                            launches=dict(launches),
                            capture_seconds=time.perf_counter() - start,
                            pool_bytes=pool_bytes))
      pool.done.record(current)
      return result

  def _replay(self, capture: Capture, args):
    with profiling.span(self._replay_span):
      current = torch.cuda.current_stream(self.device)
      # A caller on another stream may still be reading the pool.
      current.wait_event(self.pool.done)
      for dst, src in zip(tree_tensors(capture.inputs), tree_tensors(args)):
        dst.copy_(src, non_blocking=True)
      capture.graph.replay()
      _kernels.add_replay(capture.launches)
      result = tree_map(torch.clone, capture.outputs)
      self.pool.done.record(current)
      return result
