"""Every public name of the JAX package has its counterpart in the port.

Both packages are parsed with `ast`, not imported. A JAX module's public
top-level functions, classes and constants must be defined at the top
level of the port's module of the same path, under the same name, unless
this file says otherwise with a reason: the port folds a module into
another (`FOLDED`), gives a name another name (`RENAMED`), or leaves a
module or a name out because its job is the TPU's or JAX's and has none
in PyTorch (`MODULES_LEFT_OUT`, `LEFT_OUT`). Each entry of those tables
is checked too, so none outlives the fact it records.

Then the two names that the port gained last are held against the JAX
package on the CPU: `data/augmentations.augment_batch` (one JAX compile)
and `io/params_io.is_native_bundle`.
"""
import ast
import math
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.data import augmentations as jax_aug
from frame_interpolation_tpu.io import params_io as jax_params_io
from frame_interpolation_tpu_torch.data import augmentations
from frame_interpolation_tpu_torch.io import params_io

_ROOT = Path(__file__).resolve().parent.parent
JAX_DIR = _ROOT / 'frame_interpolation_tpu'
PORT_DIR = _ROOT / 'frame_interpolation_tpu_torch'

# JAX modules that the port folds into another of its modules.
FOLDED = {
    'ops/warp_window.py': 'ops/warp.py',
    'ops/warp_splat.py': 'ops/warp.py',
    'ops/conv_stack_wide.py': 'ops/conv_stack.py',
}

# JAX modules with no counterpart, and why.
MODULES_LEFT_OUT = {
    'ops/folded_conv.py': 'W-fold and quad-fold conv layouts, which exist '
                          'because XLA pads conv lanes to 128 on the TPU; '
                          'the port convolves NHWC as it is',
    'utils/xla_options.py': "XLA's compiler options and ahead-of-time "
                            'compilation; the port has no XLA',
}

# (JAX module, name) -> the port's name for it, in the counterpart module,
# or 'module:name' in another one.
RENAMED = {
    ('ops/warp_window.py', 'backward_warp_window'): 'backward_warp_kernel',
    ('ops/warp_window.py', 'backward_warp_window_rows'):
        'backward_warp_rows_kernel',
    # B5 and B6: one kernel serves every plane size.
    ('ops/warp_splat.py', 'backward_warp_splat'): 'splat_kernel',
    ('ops/warp_splat.py', 'backward_warp_splat_resident'): 'splat_kernel',
    # The warp's image cotangent, chosen in its VJP.
    ('ops/warp.py', 'image_cotangent'): 'BackwardWarp',
    # The row-sharded forward's context: a RowShard a shard's thread.
    ('ops/warp.py', 'spmd_rows_mesh'): 'ops/rows.py:sharding',
    ('ops/conv_stack.py', 'spmd_rows_ctx'): 'ops/rows.py:current',
    # The extractor's fused conv stacks: the port's extractor calls one
    # conv (+ pool) at each kernel site, through its autograd Function.
    ('ops/conv_stack.py', 'extractor_stack'): 'conv3x3_leaky',
    ('ops/conv_stack.py', 'conv_stack_flat'): 'conv3x3_leaky_kernel',
    ('ops/conv_stack_wide.py', 'wide_extractor_stack'): 'conv3x3_leaky',
    ('ops/conv_stack_wide.py', 'conv_flat'): 'conv3x3_leaky_kernel',
}

_GEOMETRY = ("the TPU kernels' pair-flat and flat layouts (tall frames, "
             'lane pairs, guard rows); the CUDA kernel reads NHWC as it is')
_MODE = ("options.conv_stack's choice of the Pallas kernel by platform, "
         'dtype and size; on CUDA the kernel always runs')
_CLI = ("absl's app.run wrapper for a console script; the port's CLIs "
        'parse their flags with argparse in main()')

# (JAX module, name) -> why the port has no counterpart.
LEFT_OUT = {
    ('cli/_common.py', 'define_flag'): 'absl flags; the port uses argparse',
    ('cli/_common.py', 'apply_platform_flag'):
        "selects JAX's platform; the port's CLIs take --device",
    **{(f'cli/{name}.py', 'cli'): _CLI for name in (
        'build_params', 'create_middlebury_tfrecord', 'create_ucf101_tfrecord',
        'create_vimeo90K_tfrecord', 'create_xiph_tfrecord', 'eval_benchmark',
        'interpolate_dir', 'interpolate_pair', 'train', 'verify_released')},
    ('inference/interpolator.py', 'expand_tree_program'):
        'a jitted whole-tree program; the port captures a CUDA graph a '
        'chunk (Interpolator.expand_tree_device, utils/programs.py)',
    ('inference/cached_tree.py', 'expand_tree_cached_program'):
        'a jitted whole-tree program; the port captures a CUDA graph a '
        'pair (cached_tree.expand_pair)',
    ('inference/cached_tree.py', 'expand_tree_cached_tiled_program'):
        "the same under patch tiling; a CUDA graph a patch's pair",
    ('parallel/mesh.py', 'batch_sharded'):
        'a JAX NamedSharding spec; the port places tensors by device',
    ('parallel/mesh.py', 'replicated'):
        'a JAX NamedSharding spec; parallel/mesh.replicate copies a model '
        'to each device',
    ('ops/warp.py', 'backward_warp_impl'):
        "the choice among JAX's warp implementations (options.warp_impl); "
        'the port has one warp a device',
    ('ops/warp_splat.py', 'backward_warp_splat_small'):
        'the small-plane matmul splat, a routing for the TPU',
    **{('ops/conv_stack.py', name): _GEOMETRY for name in (
        'C', 'Geometry', 'geometry', 'pad_image_tall', 'mask_tall',
        'pair_width', 'pack_weights_combined', 'features_from_flat',
        'pooled_from_flat', 'default_tm')},
    ('ops/conv_stack.py', 'resolve_mode'): _MODE,
    ('ops/conv_stack.py', 'slab_shape'):
        "gates the fused stack on a shard's slab under GSPMD; the port's "
        'row shards split a level by ops/rows.splits',
    **{('ops/conv_stack_wide.py', name): _GEOMETRY for name in (
        'FlatGeometry', 'flat_geometry', 'pad_image_tall_flat',
        'mask_tall_flat', 'features_from_flat', 'pooled_from_half',
        'default_tm_wide')},
    ('ops/conv_stack_wide.py', 'resolve_wide_mode'): _MODE,
}


def public_names(path: Path) -> set:
  """The public names a module defines at its top level."""
  names = set()
  for node in ast.parse(path.read_text()).body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      names.add(node.name)
    elif isinstance(node, ast.Assign):
      names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                        ast.Name):
      names.add(node.target.id)
  return {n for n in names if not n.startswith('_')}


def _jax_modules():
  return sorted(p.relative_to(JAX_DIR).as_posix()
                for p in JAX_DIR.rglob('*.py'))


def test_the_tables_name_jax_modules():
  modules = set(_jax_modules())
  assert set(FOLDED) <= modules and set(MODULES_LEFT_OUT) <= modules
  for module, _ in list(RENAMED) + list(LEFT_OUT):
    assert module in modules, module
  assert not set(RENAMED) & set(LEFT_OUT)
  for reason in list(MODULES_LEFT_OUT.values()) + list(LEFT_OUT.values()):
    assert reason.strip()


@pytest.mark.parametrize('module', _jax_modules())
def test_every_public_name_has_a_counterpart(module):
  if module in MODULES_LEFT_OUT:
    assert not (PORT_DIR / module).exists(), module
    return
  counterpart = FOLDED.get(module, module)
  assert (module in FOLDED) != (PORT_DIR / module).exists(), module
  ported = public_names(PORT_DIR / counterpart)
  missing = []
  for name in sorted(public_names(JAX_DIR / module)):
    key = (module, name)
    if key in LEFT_OUT:
      # Kept true: a name the port gains leaves the table.
      assert name not in ported, f'{key} is ported; drop it from LEFT_OUT'
    elif key in RENAMED:
      where, _, other = RENAMED[key].rpartition(':')
      assert other in public_names(PORT_DIR / (where or counterpart)), key
    elif name not in ported:
      missing.append(name)
  assert not missing, f'{module}: no counterpart in {counterpart} for {missing}'
  for key in list(RENAMED) + list(LEFT_OUT):
    if key[0] == module:
      assert key[1] in public_names(JAX_DIR / module), key


# ---- the two names the port gained last ---------------------------------------

_NAMES = ('random_image_rot90', 'random_flip', 'random_rotate',
          'random_reverse')
# max-abs, images in [0, 1]: the rotation's angle and bilinear weights in
# f32 by two frameworks (tests/test_torch_data.py's bound).
_AUG_BOUND = 1e-5


def _jax_draws(seed: int, batch: int) -> np.ndarray:
  """The draws JAX's augment_batch makes from PRNGKey(seed), in the port's
  rows: rot90's k, the flip's coin, the rotation's coin and its uniform in
  [0, 1), the reversal's coin; one column an example."""
  rows = [[] for _ in range(5)]
  for key in jax.random.split(jax.random.PRNGKey(seed), batch):
    keys = [jax.random.fold_in(key, i) for i in range(len(_NAMES))]
    rows[0].append(jax.random.randint(keys[0], (), 0, 4))
    rows[1].append(jax.random.randint(keys[1], (), 0, 2))
    key_prob, key_angle = jax.random.split(keys[2])
    rows[2].append(jax.random.randint(key_prob, (), 0, 2))
    rows[3].append(jax.random.uniform(key_angle, ()))
    rows[4].append(jax.random.randint(keys[3], (), 0, 2))
  return np.asarray(rows, np.float32)


def test_augment_batch_equals_jax_on_the_same_draws(monkeypatch):
  # Each framework draws from its own generator, so the port's draws are
  # replaced by the ones JAX makes from the same seed; what is held is the
  # rest: the names' order, the draws' rows, the per-example application.
  seed, n = 2, 4
  rng = np.random.RandomState(2)
  batch = {k: rng.rand(n, 12, 12, 3).astype(np.float32)
           for k in ('x0', 'x1', 'y')}
  batch['time'] = np.full((n, 1), 0.5, np.float32)
  draws = torch.from_numpy(_jax_draws(seed, n))
  rows = {'random_image_rot90': draws[0:1], 'random_flip': draws[1:2],
          'random_rotate': draws[2:4], 'random_reverse': draws[4:5]}
  for name in _NAMES:
    aug = augmentations._REGISTRY[name]
    monkeypatch.setitem(augmentations._REGISTRY, name, aug._replace(
        draw=lambda generator, b, r=rows[name]: list(r)))
  got = augmentations.augment_batch(
      torch.Generator().manual_seed(seed),
      {k: torch.from_numpy(v) for k, v in batch.items()}, list(_NAMES))
  want = jax_aug.augment_batch(jax.random.PRNGKey(seed), batch, _NAMES)
  # Each augmentation moves some example under these draws.
  assert all(draws[row].max() > 0 for row in (0, 1, 2, 4))
  for key in ('x0', 'x1', 'y'):
    err = float(np.abs(got[key].numpy() - np.asarray(want[key])).max())
    assert err <= _AUG_BOUND, (key, err)
  assert torch.equal(got['time'], torch.from_numpy(batch['time']))
  # The angle the port derives from a uniform is JAX's, to f32 rounding.
  jax_angles = np.asarray([
      jax.random.uniform(jax.random.split(jax.random.fold_in(k, 2))[1], (),
                         minval=-0.25 * math.pi, maxval=0.25 * math.pi)
      for k in jax.random.split(jax.random.PRNGKey(seed), n)])
  port_angles = ((draws[3] * 0.5 - 0.25) * math.pi).numpy()
  np.testing.assert_allclose(port_angles, jax_angles, rtol=0, atol=1e-6)


def test_augment_batch_is_apply_data_augmentation_by_name():
  rng = np.random.RandomState(3)
  batch = {k: torch.from_numpy(rng.rand(4, 12, 12, 3).astype(np.float32))
           for k in ('x0', 'x1', 'y')}
  got = augmentations.augment_batch(torch.Generator().manual_seed(5), batch,
                                    _NAMES)
  want = augmentations.apply_data_augmentation(
      augmentations.data_augmentations(_NAMES),
      torch.Generator().manual_seed(5), batch)
  for key in batch:
    assert torch.equal(got[key], want[key])
  with pytest.raises(AttributeError):
    augmentations.augment_batch(torch.Generator(), batch, ['random_zoom'])


@pytest.mark.parametrize('files,expected', [
    (('options.json', 'params.msgpack'), True),
    (('options.json',), False),
    (('params.msgpack',), False),
    (('options.json', 'state_dict.pt'), False),
    ((), False),
])
def test_is_native_bundle_agrees_with_jax(tmp_path, files, expected):
  for name in files:
    (tmp_path / name).write_bytes(b'{}')
  path = os.fspath(tmp_path)
  assert params_io.is_native_bundle(path) is expected
  assert jax_params_io.is_native_bundle(path) is expected
  assert params_io.is_native_bundle is params_io.is_jax_bundle
