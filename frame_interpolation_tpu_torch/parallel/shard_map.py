"""Shards in threads, and the collectives between them.

Counterpart of `jax.shard_map` with `lax.ppermute`, `lax.all_gather` and
`lax.pmax`, which the JAX package's sharded serving runs on
(parallel/inference.py, ops/warp_window.py backward_warp_window_rows,
ops/conv_stack.py stack_rows). JAX runs one program over a device mesh;
here each shard is a Python thread on its own device, the way
`torch.nn.parallel.parallel_apply` runs replicas, and the shards exchange
tensors through a `Collective`: a barrier and a slot per shard. A tensor
crosses devices by `.to(device)`, which orders the two devices' current
streams. Shards that share one device share its current stream, so their
launches run in the order the threads make them.

Threads, not `torch.distributed`: NCCL cannot put two ranks on one GPU,
and a mesh that repeats one device (`[cuda:0] * 4`) is what runs every
halo, gather and row-mode kernel of the sharded paths on a single card,
as the JAX tests' virtual 8-device CPU mesh does for JAX.

A `ShardPool` keeps one thread a shard for its lifetime, and each call
runs shard i on thread i: PyTorch keeps some caches per thread (cuDNN's
execution plans among them), which a fresh thread a call would build
again on every call.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from typing import Any, Callable, List, Optional, Sequence

import torch

# Seconds a shard waits at a barrier for the others before it gives up.
TIMEOUT_S = 600.0


class ShardAborted(RuntimeError):
  """Raised in a shard whose collective was broken by another shard's
  failure, or by the barrier's timeout."""


class Collective:
  """`n` shards exchanging one value each per call, in lockstep.

  `exchange(index, value)` returns every shard's value of the same call,
  in shard order. All shards must make the same calls in the same order.
  Two slot sets alternate between calls, so one barrier a call suffices: a
  shard cannot reach call k+2, which reuses call k's slots, before every
  shard has left call k's barrier and read its values.
  """

  def __init__(self, n: int, timeout: float = TIMEOUT_S):
    self.n = n
    self._barrier = threading.Barrier(n, timeout=timeout)
    self._slots = [[None] * n, [None] * n]
    self._calls = [0] * n

  def exchange(self, index: int, value: Any) -> List[Any]:
    slots = self._slots[self._calls[index] % 2]
    self._calls[index] += 1
    slots[index] = value
    try:
      self._barrier.wait()
    except threading.BrokenBarrierError:
      raise ShardAborted('another shard failed, or the shards did not meet '
                         'within the timeout') from None
    return list(slots)

  def abort(self) -> None:
    """Breaks the barrier: every shard waiting, or arriving later, raises
    ShardAborted."""
    self._barrier.abort()


def _device_scope(device: torch.device):
  if device.type == 'cuda':
    return torch.cuda.device(device)
  return contextlib.nullcontext()


def _serve(tasks: 'queue.Queue') -> None:
  """A shard thread: runs each task it is given until it gets None."""
  while True:
    task = tasks.get()
    if task is None:
      return
    task()
    del task  # holds the caller's closure until the next task otherwise


class ShardPool:
  """One long-lived thread a shard of `devices`.

  `run(fn, collective)` runs fn(index) for every shard, shard i on thread
  i, each with the caller's grad and inference modes and its device
  current. A shard that raises aborts `collective`, so the others stop at
  their next exchange instead of waiting; the first failure is raised
  once every shard has ended (a ShardAborted only when no shard failed
  otherwise). Returns the shards' results in order. The threads end with
  `close()`, or when the pool is collected.
  """

  def __init__(self, devices: Sequence[torch.device]):
    self.devices = tuple(devices)
    self._queues = [queue.Queue() for _ in self.devices]
    self._threads = [threading.Thread(target=_serve, args=(q,), daemon=True,
                                      name=f'shard-{i}')
                     for i, q in enumerate(self._queues)]
    for t in self._threads:
      t.start()
    self._close = weakref.finalize(self, _stop, self._queues)

  def run(self, fn: Callable[[int], Any],
          collective: Optional[Collective] = None) -> List[Any]:
    n = len(self.devices)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    done = threading.Semaphore(0)
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    def task(index: int) -> None:
      try:
        with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
            _device_scope(self.devices[index]):
          results[index] = fn(index)
      except BaseException as e:  # re-raised in the caller's thread below
        errors[index] = e
        if collective is not None:
          collective.abort()
      finally:
        done.release()

    for index, tasks in enumerate(self._queues):
      tasks.put(lambda index=index: task(index))
    for _ in range(n):
      done.acquire()
    failed = [e for e in errors if e is not None]
    if failed:
      raise next((e for e in failed if not isinstance(e, ShardAborted)),
                 failed[0])
    return results

  def close(self) -> None:
    """Ends the threads once their current tasks are done."""
    self._close()

  def __enter__(self) -> 'ShardPool':
    return self

  def __exit__(self, *exc) -> None:
    self.close()


def _stop(queues) -> None:
  for tasks in queues:
    tasks.put(None)


def run_shards(fn: Callable[[int], Any], devices: Sequence[torch.device],
               collective: Optional[Collective] = None) -> List[Any]:
  """`ShardPool(devices).run(fn, collective)` on threads made for this
  call alone."""
  with ShardPool(devices) as pool:
    return pool.run(fn, collective)
