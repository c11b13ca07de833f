"""Pair and video inference: pad -> forward -> crop, tiling, the frame tree.

Port of frame_interpolation_tpu/inference/interpolator.py.
`interpolate` pads the frames to the alignment grid, runs FilmNet and crops
back; `__call__` also folds the frame into a block_shape grid of patches
and runs them as one batch. Both take and return numpy arrays;
`call_device` takes and returns tensors on the interpolator's device.

Video: `expand_tree_device` expands N frames to (N-1)*2^T+1 by recursive
midpoints on the device, by one of two routes. The feature-cached DFS
(inference/cached_tree.py, the default) extracts each frame's features
once, at batch 1, and skips extraction at the final depth's leaves. The
chunked tree runs every depth's pairs as whole forwards in batches of
`max_batch`. `features_device` and `midpoint_from_features_device` are the
cached route's two steps, which the host-side DFS of inference/recursion.py
also drives.

The exact uint8 rules: uint8 frames cross to the device as uint8 and become
f32 there through a 256-entry table of the correctly rounded v / 255, equal
bit for bit to io.images.read_image (on CUDA `x / 255` multiplies by the
reciprocal, which differs in the last place for about half the byte
values); outputs quantize with io.images.to_uint8's rule,
(clip(x * 255, 0, 255) + 0.5) truncated.

The model ignores the time value and predicts the midpoint; other
timestamps come from recursive invocation.

On a CUDA device each of these is one captured program (utils/programs.py),
as each is one jitted program in the JAX package: the pair (pad -> model
-> crop), the pair with every output of the forward (`_forward_all`
there), the features of a frame, a midpoint from two frames' features,
and one input pair's whole cached tree. A call then replays a CUDA graph
per key (shapes, dtypes, the static arguments) instead of issuing every
launch from Python; the tiled pair, the chunked tree, the recursion drivers
and the sharded classes reach them through these methods. `graphs=False`
is the eager path, the one the CPU always takes. The graphs hold their
memory in one pool, bounded as utils/programs.py says (a new shape past
the pool's budget drops the others); a capture or replay that fails
raises.

Under a profiler (utils/profiling.span) each crossing to the device is an
`fi.upload` span and each numpy result of a pair an `fi.download` span,
opened once the device has computed the result, so that it times the
copy and not the device's work.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..io import params_io, tf_import
from ..models.film_net import FilmNet, Features
from ..ops import tiling
from ..options import Options
from ..utils import profiling, programs
from . import cached_tree

# The correctly rounded v / 255 of every byte value: numpy's f32 division,
# as io.images.read_image computes it.
_U8_TO_UNIT = np.arange(256, dtype=np.float32) / np.float32(255)


_PAGE_BYTES = 4096


def touched_empty(t: torch.Tensor) -> np.ndarray:
  """A new numpy array of t's shape and dtype with every page written once.
  A fresh array's first writes fault its pages in: a 4K f32 frame is 100
  MB, ~30 ms of faults, which a copy into it would wait on; touched while
  the device computes, they are paid off the request's path."""
  host = torch.empty(t.shape, dtype=t.dtype).numpy()
  host.reshape(-1).view(np.uint8)[::_PAGE_BYTES] = 0
  return host


def u8_to_unit_f32(frames: torch.Tensor) -> torch.Tensor:
  """uint8 -> [0, 1] f32 on the frames' device, equal to read_image."""
  table = torch.from_numpy(_U8_TO_UNIT).to(frames.device)
  return table[frames.long()]


def as_model(params_or_model: Any, options: Options) -> FilmNet:
  if isinstance(params_or_model, nn.Module):
    return params_or_model
  if not isinstance(params_or_model, Mapping):
    raise TypeError('expected a FilmNet, a state_dict or a flax parameter '
                    f'tree; got {type(params_or_model).__name__}')
  state = params_or_model
  if any(isinstance(v, Mapping) for v in state.values()):
    state = params_io.from_flax_params(state)
  model = FilmNet(options)
  model.load_state_dict(state)
  return model


class Interpolator:
  """Generates the frame between two frames with the film_net model.

  Usage:
    interp = Interpolator(model, options, align=64, device='cuda')
    mid = interp(x0_batch, x1_batch, dt_batch)   # numpy in, numpy out
    video = interp.expand_tree_device(frames, times_to_interpolate=3)

  `params_or_model` is a FilmNet, its state_dict, or the JAX package's
  flax parameter tree. A 'cuda' device needs a visible GPU; there is no
  fallback to the CPU. `graphs`: run the entry points as captured CUDA
  graphs (None: on a CUDA device); True on the CPU raises. `pool`: the
  graphs' memory pool, to share with other Interpolators on the device
  (the sharded classes give the shards on one device one pool); a pool
  of its own by default.
  """

  def __init__(self, params_or_model: Any, options: Options,
               align: Optional[int] = 64,
               block_shape: Optional[Sequence[int]] = None,
               device: Any = 'cuda', graphs: Optional[bool] = None,
               pool: Optional[programs.Pool] = None) -> None:
    self._device = torch.device(device)
    if self._device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError('Interpolator: device cuda requested but no GPU is '
                         'visible to torch.')
    self._options = options
    self._align = align or None
    self._block_shape = tuple(block_shape) if block_shape else None
    self._model = as_model(params_or_model, options).to(self._device).eval()
    self._programs: Dict[str, programs.Program] = {}
    if programs.resolve(graphs, self._device, 'Interpolator'):
      # One pool for the five, bounded as a whole.
      self._pool = pool or programs.Pool()
      self._programs = {
          name: programs.Program(programs.weak_method(fn), self._device,
                                 name, pool=self._pool)
          for name, fn in (('pair', self._pair_eager),
                           ('all_outputs', self._all_outputs_eager),
                           ('features', self._features_eager),
                           ('midpoint', self._midpoint_eager),
                           ('tree_pair', self._tree_pair_eager))}
    self._weights_version = self._version()

  @property
  def options(self) -> Options:
    return self._options

  @property
  def model(self) -> FilmNet:
    return self._model

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def graphs(self) -> bool:
    """Whether the entry points run as captured programs."""
    return bool(self._programs)

  @property
  def programs(self) -> Dict[str, programs.Program]:
    """The captured programs by name (empty on the eager path)."""
    return dict(self._programs)

  def release_graphs(self) -> None:
    """Destroys the captured graphs, those of other Interpolators given the
    same pool too; their memory goes back to the device. Later calls
    capture again."""
    if self._programs:
      self._pool.clear()

  def _version(self) -> int:
    return sum(p._version for p in self._model.parameters())

  def _run(self, name: str, eager_fn, *args, **static):
    """`eager_fn(*args, **static)` under inference mode, through its
    program where there are programs. A weight written in place since the
    graphs were captured (training the model further) drops them."""
    with torch.inference_mode():
      if not self._programs:
        return eager_fn(*args, **static)
      version = self._version()
      if version != self._weights_version:
        self.release_graphs()
        self._weights_version = version
      return self._programs[name](*args, **static)

  def tiled(self) -> bool:
    """Whether `block_shape` spans more than one patch."""
    return (self._block_shape is not None and
            int(np.prod(self._block_shape)) > 1)

  def _on_device(self, x: Any) -> bool:
    return isinstance(x, torch.Tensor) and (
        x.device.type == self._device.type and
        self._device.index in (None, x.device.index))

  def to_device(self, x: Any) -> torch.Tensor:
    """numpy or tensor -> f32 tensor on the device; uint8 frames cross as
    uint8 and convert there, exactly as read_image does. A crossing is
    one `fi.upload` span."""
    if self._on_device(x):
      return u8_to_unit_f32(x) if x.dtype == torch.uint8 else x.float()
    with profiling.span('fi.upload'):
      if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
      x = x.to(self._device)
      return u8_to_unit_f32(x) if x.dtype == torch.uint8 else x.float()

  def _to_host(self, out: torch.Tensor) -> np.ndarray:
    """A result as numpy, once the device has computed it: the copy alone
    is the `fi.download` span. A CUDA result lands in a new array whose
    pages were touched while the device computed (`touched_empty`)."""
    if not out.is_cuda:
      with profiling.span('fi.download'):
        return out.cpu().numpy()
    host = touched_empty(out)
    torch.cuda.current_stream(out.device).synchronize()
    with profiling.span('fi.download'):
      torch.from_numpy(host).copy_(out)
      return host

  # ---- pairs -----------------------------------------------------------------

  def interpolate_device(self, x0: torch.Tensor, x1: torch.Tensor,
                         dt: torch.Tensor) -> torch.Tensor:
    """Pads to alignment, runs the model, crops back. Stays on device.

    x0, x1: (B, H, W, 3) float32 in [0, 1]; dt: (B,). Returns (B, H, W, 3).
    The pair program: one replay a call on the graphs' path.
    """
    return self._run('pair', self._pair_eager, x0, x1, dt)

  def _pair_eager(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    time = dt.reshape(-1, 1).float()
    bbox = None
    if self._align is not None:
      x0, bbox = tiling.pad_to_align(x0, self._align)
      x1, _ = tiling.pad_to_align(x1, self._align)
    image = self._model(x0, x1, time)['image']
    if bbox is not None:
      image = tiling.crop_to_bounding_box(image, **bbox)
    return image.contiguous()

  def interpolate_all_outputs(self, x0: Any, x1: Any,
                              dt: Any) -> Dict[str, Any]:
    """The padded forward with its aux outputs (flows, warps) as device
    tensors; only the image is cropped back. The all-outputs program:
    one replay a call on the graphs' path."""
    return self._run('all_outputs', self._all_outputs_eager,
                     self.to_device(x0), self.to_device(x1),
                     self.to_device(dt))

  def _all_outputs_eager(self, x0: torch.Tensor, x1: torch.Tensor,
                         dt: torch.Tensor) -> Dict[str, Any]:
    bbox = None
    if self._align is not None:
      x0, bbox = tiling.pad_to_align(x0, self._align)
      x1, _ = tiling.pad_to_align(x1, self._align)
    outputs = dict(self._model(x0, x1, dt.reshape(-1, 1)))
    if bbox is not None:
      outputs['image'] = tiling.crop_to_bounding_box(outputs['image'],
                                                     **bbox)
    return outputs

  def call_device(self, x0: torch.Tensor, x1: torch.Tensor,
                  dt: torch.Tensor) -> torch.Tensor:
    """`interpolate_device` with patch tiling (all patches as one batch)."""
    if not self.tiled():
      return self.interpolate_device(x0, x1, dt)
    x0_patches = tiling.image_to_patches(x0, self._block_shape)
    x1_patches = tiling.image_to_patches(x1, self._block_shape)
    dt_patches = dt[:1].expand(x0_patches.shape[0])
    out = self.interpolate_device(x0_patches, x1_patches, dt_patches)
    return tiling.patches_to_image(out, self._block_shape)

  def interpolate(self, x0: np.ndarray, x1: np.ndarray,
                  dt: np.ndarray) -> np.ndarray:
    """Pad -> forward -> crop, numpy in and out (no patch tiling)."""
    out = self.interpolate_device(self.to_device(x0), self.to_device(x1),
                                  self.to_device(dt))
    return self._to_host(out)

  def __call__(self, x0: np.ndarray, x1: np.ndarray,
               dt: np.ndarray) -> np.ndarray:
    out = self.call_device(self.to_device(x0), self.to_device(x1),
                           self.to_device(dt))
    return self._to_host(out)

  # ---- the feature-cached steps ----------------------------------------------

  def features_device(self, x: Any) -> Features:
    """(image_pyramid, feature_pyramid) of frames (B, H, W, 3), padded to
    the alignment grid first; reusable across every pair they are in."""
    return self._run('features', self._features_eager, self.to_device(x))

  def _features_eager(self, x: torch.Tensor) -> Features:
    if self._align is not None:
      x, _ = tiling.pad_to_align(x, self._align)
    return self._model.extract_features(x)

  def midpoint_from_features_device(
      self, f0: Features, f1: Features, orig_hw: Sequence[int],
      as_uint8: bool = False,
      with_features: bool = True) -> Tuple[torch.Tensor, Optional[Features]]:
    """The midpoint frame, cropped to `orig_hw`, and its own features.

    The features are those of the cropped midpoint padded again with zeros,
    equal to `features_device(midpoint)`, so the cached recursion computes
    what the uncached one does. `as_uint8` quantizes the returned frame
    with the writers' rule (the features come from the f32 frame);
    `with_features=False` skips the extraction and returns None for them.
    """
    return self._run('midpoint', self._midpoint_eager, f0, f1,
                     orig_hw=tuple(int(s) for s in orig_hw),
                     as_uint8=bool(as_uint8),
                     with_features=bool(with_features))

  def _midpoint_eager(self, f0: Features, f1: Features,
                      orig_hw: Tuple[int, int], as_uint8: bool,
                      with_features: bool
                      ) -> Tuple[torch.Tensor, Optional[Features]]:
    batch = f0[0][0].shape[0]
    time = torch.full((batch, 1), 0.5, dtype=torch.float32,
                      device=self._device)
    image = self._model.interpolate_from_features(f0, f1, time)['image']
    if self._align is not None:
      height, width = orig_hw
      image = tiling.crop_to_bounding_box(
          image, offset_height=(image.shape[1] - height) // 2,
          offset_width=(image.shape[2] - width) // 2,
          target_height=height, target_width=width)
    features = None
    if with_features:
      repadded = image
      if self._align is not None:
        repadded, _ = tiling.pad_to_align(image, self._align)
      features = self._model.extract_features(repadded)
    image = cached_tree.quantize_u8(image) if as_uint8 else image
    return image.contiguous(), features

  def tree_pair_device(self, left: Features, right_frame: torch.Tensor,
                       times: int, as_uint8: bool = False
                       ) -> Tuple[torch.Tensor, Features]:
    """One input pair's whole cached tree (inference/cached_tree.py
    `expand_pair`): the 2^times - 1 midpoints between the frame whose
    features are `left` and `right_frame` (1, H, W, 3) f32, in time
    order, and `right_frame`'s features, which the next pair takes as its
    `left`. One replay a pair on the graphs' path."""
    return self._run('tree_pair', self._tree_pair_eager, left, right_frame,
                     times=int(times), as_uint8=bool(as_uint8))

  def _tree_pair_eager(self, left: Features, right_frame: torch.Tensor,
                       times: int, as_uint8: bool
                       ) -> Tuple[torch.Tensor, Features]:
    orig_hw = (int(right_frame.shape[1]), int(right_frame.shape[2]))
    return cached_tree.expand_pair(
        self._features_eager,
        lambda f0, f1, with_features: self._midpoint_eager(
            f0, f1, orig_hw, as_uint8, with_features),
        left, right_frame, times)

  # ---- the frame tree ----------------------------------------------------------

  def expand_tree_device(self, frames: Any, times_to_interpolate: int,
                         max_batch: int = 8, as_uint8: bool = False,
                         cached: Optional[bool] = None) -> torch.Tensor:
    """Expands (N, H, W, 3) frames to ((N-1)*2^T + 1, H, W, 3) on device.

    `frames`: numpy or tensor, f32 in [0, 1] or uint8 (which crosses to the
    device as uint8 and converts exactly). `as_uint8` returns the frames
    quantized with io.images.to_uint8's rule, a quarter of the fetch.
    `cached` picks the feature-cached DFS (the default, or FI_TREE_CACHED=0
    for the chunked tree); the two agree to float noise. With patch tiling
    the cached tree of every patch runs in turn and the frames are
    reassembled once at the end (the tree commutes with tiling).
    """
    frames = self.to_device(frames)
    if cached is None:
      cached = os.environ.get('FI_TREE_CACHED', '1') != '0'
    with torch.inference_mode():
      if self.tiled():
        return cached_tree.expand_tree_cached_tiled(
            self, frames, times_to_interpolate, as_uint8, self._block_shape)
      if cached:
        return cached_tree.expand_tree_cached(self, frames,
                                              times_to_interpolate, as_uint8)
      return expand_tree_chunked(frames, times_to_interpolate, max_batch,
                                 as_uint8, self.interpolate_device)


def expand_tree_chunked(frames: torch.Tensor, times: int, max_batch: int,
                        as_uint8: bool, forward,
                        batch_quantum: int = 1) -> torch.Tensor:
  """The uncached tree: each depth's pairs as whole forwards in chunks of
  min(max_batch, pairs), the ragged last chunk filled with copies of the
  first frame, then the midpoints interleaved in time order.

  `forward(x0, x1, dt)` runs one chunk (Interpolator.interpolate_device).
  Chunks are rounded up to a multiple of `batch_quantum`, so that a
  forward sharded over a mesh of that many devices splits every chunk
  evenly (parallel/inference.ShardedVideoInterpolator): the hooks of
  expand_tree_program in the JAX package.
  """
  q = batch_quantum
  seq = frames
  n_frames = seq.shape[0]
  for _ in range(times if n_frames >= 2 else 0):
    n = seq.shape[0] - 1
    chunk = min(max(max_batch, q), -(-n // q) * q)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    x0, x1 = seq[:-1], seq[1:]
    if pad:
      filler = seq[:1].expand((pad,) + tuple(seq.shape[1:]))
      x0 = torch.cat([x0, filler])
      x1 = torch.cat([x1, filler])
    dt = torch.full((chunk,), 0.5, dtype=torch.float32, device=seq.device)
    mids = torch.cat([
        forward(x0[c * chunk:(c + 1) * chunk].contiguous(),
                x1[c * chunk:(c + 1) * chunk].contiguous(), dt)
        for c in range(n_chunks)])[:n]
    merged = torch.stack([seq[:-1], mids], dim=1)
    merged = merged.reshape((2 * n,) + tuple(seq.shape[1:]))
    seq = torch.cat([merged, seq[-1:]])
  return cached_tree.quantize_u8(seq) if as_uint8 else seq.contiguous()


def load_interpolator(model_path: str,
                      align: Optional[int] = 64,
                      block_shape: Optional[Sequence[int]] = None,
                      dtype_policy: Optional[str] = None,
                      device: Any = 'cuda') -> Interpolator:
  """An Interpolator from a bundle, the port's own (`options.json` +
  `state_dict.pt`, which the trainer exports) or the JAX package's
  (`options.json` + `params.msgpack`), or from a TF release of the
  reference: a SavedModel or checkpoint directory, or a checkpoint prefix,
  in the released configuration (io/tf_import, no TensorFlow needed).
  `dtype_policy` overrides the bundle's or the release's."""
  if os.path.isfile(os.path.join(model_path, params_io.STATE_FILE)):
    state, options = params_io.load_state_bundle(model_path)
  elif params_io.is_jax_bundle(model_path):
    state, options = params_io.load_params(model_path)
  elif (params_io.is_tf_saved_model(model_path) or
        params_io.is_tf_checkpoint_dir(model_path)):
    state, options = tf_import.load_tf_params(model_path)
  else:
    raise FileNotFoundError(
        f'{model_path}: neither a bundle of the port (options.json + '
        f'{params_io.STATE_FILE}) or of the JAX package (options.json + '
        f'{params_io.PARAMS_FILE}) nor a TF2 SavedModel or checkpoint')
  if dtype_policy is not None and dtype_policy != options.dtype_policy:
    options = dataclasses.replace(options, dtype_policy=dtype_policy)
  return Interpolator(state, options, align=align, block_shape=block_shape,
                      device=device)
