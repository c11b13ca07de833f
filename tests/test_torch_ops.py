"""The PyTorch port's ops against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through each JAX op and
its counterpart in frame_interpolation_tpu_torch. On a CPU tensor the
port's warp and conv-stack wrappers run their plain PyTorch versions, so
these tests pin the plain versions that the CUDA kernels are held against
on the GPU (chip_smoke.py). The TPU kernels run here as their own tests run
them: Pallas in interpret mode.
"""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu import options as jax_options
from frame_interpolation_tpu.ops import conv_stack as jax_conv_stack
from frame_interpolation_tpu.ops import conv_stack_wide as jax_conv_wide
from frame_interpolation_tpu.ops import pyramid as jax_pyramid
from frame_interpolation_tpu.ops import resize as jax_resize
from frame_interpolation_tpu.ops import tiling as jax_tiling
from frame_interpolation_tpu.ops import warp as jax_warp
from frame_interpolation_tpu.ops import warp_window as jax_warp_window
from frame_interpolation_tpu_torch import options as torch_options
from frame_interpolation_tpu_torch.ops import _kernels, conv_stack, pyramid
from frame_interpolation_tpu_torch.ops import resize, tiling, warp

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
  return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _np(t):
  return t.detach().float().numpy()


def _max_abs(a, b):
  return float(np.max(np.abs(np.asarray(a, np.float32) -
                             np.asarray(b, np.float32))))


# ---- options ---------------------------------------------------------------


@pytest.mark.parametrize('preset', ['film_net_released', 'tiny', None])
def test_options_fields_and_values_match(preset):
  jax_fields = {f.name: f.default
                for f in dataclasses.fields(jax_options.Options)}
  torch_fields = {f.name: f.default
                  for f in dataclasses.fields(torch_options.Options)}
  # The port drops only the TPU layout knobs; split_convs is ported, with
  # JAX's default.
  assert set(jax_fields) - set(torch_fields) == {
      'warp_impl', 'fold_convs', 'conv_stack'}
  assert set(torch_fields) <= set(jax_fields)
  assert torch_fields['split_convs'] == jax_fields['split_convs'] == 'auto'
  for mode in ('auto', 'on', 'off'):
    assert torch_options.Options(split_convs=mode).split_convs == mode
  with pytest.raises(ValueError, match='split_convs'):
    torch_options.Options(split_convs='yes')
  if preset is None:
    jo, to = jax_options.Options(), torch_options.Options()
  else:
    jo = getattr(jax_options.Options, preset)()
    to = getattr(torch_options.Options, preset)()
  for name in torch_fields:
    assert getattr(to, name) == getattr(jo, name), name
  assert to.align == jo.align and to.max_motion_px == jo.max_motion_px
  assert ([to.feature_channels(i) for i in range(to.pyramid_levels)] ==
          [jo.feature_channels(i) for i in range(jo.pyramid_levels)])


def test_options_compute_dtype():
  assert torch_options.Options().compute_dtype == torch.float32
  bf16 = torch_options.Options(dtype_policy='bfloat16')
  assert bf16.compute_dtype == torch.bfloat16
  with pytest.raises(ValueError):
    torch_options.Options(dtype_policy='float16')


# ---- warp ------------------------------------------------------------------


def _warp_case(name):
  rng = np.random.RandomState(7)
  h, w, c = (13, 29, 5) if name == 'non_tile' else (16, 24, 3)
  img = rng.rand(2, h, w, c).astype(np.float32)
  flow = np.zeros((2, h, w, 2), np.float32)
  if name == 'const_int':
    flow += np.array([3.0, -2.0], np.float32)
  elif name == 'const_frac':
    flow += np.array([0.25, -1.75], np.float32)
  elif name in ('random_oob', 'non_tile'):
    # +-30 px pushes many taps out of bounds, exercising the edge clamp.
    flow = ((rng.rand(2, h, w, 2) - 0.5) * 60.0).astype(np.float32)
  return img, flow


@pytest.mark.parametrize(
    'case', ['zero', 'const_int', 'const_frac', 'random_oob', 'non_tile'])
def test_warp_f32_matches_jax(case):
  img, flow = _warp_case(case)
  want = jax_warp.backward_warp(jnp.asarray(img), jnp.asarray(flow))
  got = warp.backward_warp(_t(img), _t(flow))
  assert got.dtype == torch.float32
  assert _max_abs(_np(got), want) <= 1e-5


def test_warp_bf16_matches_jax():
  img, flow = _warp_case('random_oob')
  want = jax_warp.backward_warp(jnp.asarray(img, jnp.bfloat16),
                                jnp.asarray(flow))
  got = warp.backward_warp(_t(img, torch.bfloat16), _t(flow))
  assert got.dtype == torch.bfloat16
  # JAX blends in bf16 (one rounding per lerp); the port blends in f32 and
  # rounds once: at most two bf16 ulps of [0.5, 1).
  assert _max_abs(_np(got), np.asarray(want, np.float32)) <= 2 * 2.0**-8


def test_warp_matches_window_kernel_interpret():
  rng = np.random.RandomState(3)
  img = rng.rand(1, 16, 24, 3).astype(np.float32)
  flow = ((rng.rand(1, 16, 24, 2) - 0.5) * 12.0).astype(np.float32)
  want = jax_warp_window.backward_warp_window(jnp.asarray(img),
                                              jnp.asarray(flow), True)
  got = warp.backward_warp(_t(img), _t(flow))
  assert _max_abs(_np(got), want) <= 1e-6


@pytest.mark.parametrize('shape', [(1, 1, 8, 3), (1, 8, 1, 3)])
def test_warp_rejects_planes_below_2x2(shape):
  with pytest.raises(ValueError):
    warp.backward_warp(torch.zeros(shape), torch.zeros(shape[:3] + (2,)))


def test_kernel_wrappers_refuse_non_cuda_tensors():
  # A wrapper given anything but a CUDA tensor raises before it builds or
  # launches; it never falls back to the plain version.
  image = torch.zeros(1, 4, 4, 64)
  flow = torch.zeros(1, 4, 4, 2)
  weight = torch.zeros(64, 64, 3, 3)
  bias = torch.zeros(64)
  with pytest.raises(ValueError, match='CUDA'):
    warp.backward_warp_kernel(image, flow)
  with pytest.raises(ValueError, match='CUDA'):
    conv_stack.conv3x3_leaky_kernel(image, weight, bias, pool=True)
  with pytest.raises(ValueError, match='CUDA'):
    warp.backward_warp(image.to('meta'), flow.to('meta'))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
  # Without the CUDA toolkit the kernels cannot be built: the build raises
  # instead of leaving a wrapper to fall back.
  monkeypatch.setenv('CUDA_HOME', str(tmp_path))
  monkeypatch.delenv('CUDA_PATH', raising=False)
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.setattr(_kernels, 'BUILD_DIR', tmp_path / '_build')
  if pathlib.Path('/usr/local/cuda/bin/nvcc').is_file():
    pytest.skip('the CUDA toolkit is installed here')
  with pytest.raises(RuntimeError, match='nvcc not found'):
    _kernels._build()


# ---- conv stacks -----------------------------------------------------------


def _conv_params(rng, cin, cout):
  kernel = ((rng.rand(3, 3, cin, cout) - 0.5) * 0.2).astype(np.float32)
  bias = (rng.rand(cout) - 0.5).astype(np.float32)
  return kernel, bias


def _port_stack(head, k0, b0, k1, b1, dtype, emit_pool):
  """The port's extractor sub-level: first conv, then the fused stack."""
  x = _t(head, dtype)
  w0 = torch.from_numpy(k0.transpose(3, 2, 0, 1).copy())
  w1 = torch.from_numpy(k1.transpose(3, 2, 0, 1).copy())
  cin = k0.shape[2]
  # The model sends the first conv of sub-levels 2 and up through the
  # stack; of these cases, that is the rectangular 128->256 one.
  if cin == 128:
    y0, _ = conv_stack.conv3x3_leaky(x, w0, torch.from_numpy(b0))
  else:
    y0 = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w0.to(dtype),
                                    torch.from_numpy(b0).to(dtype), padding=1)
    y0 = torch.nn.functional.leaky_relu(y0, 0.2).permute(0, 2, 3, 1)
    y0 = y0.contiguous()
  return conv_stack.conv3x3_leaky(y0, w1, torch.from_numpy(b1),
                                  pool=emit_pool)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('cin,c,h,w', [(3, 64, 8, 12), (64, 128, 6, 10),
                                       (128, 256, 4, 6)],
                         ids=['c64', 'c128', 'rect128to256'])
def test_conv_stack_matches_jax_kernels(cin, c, h, w, dtype):
  rng = np.random.RandomState(c + cin)
  head = (rng.rand(1, h, w, cin) - 0.5).astype(np.float32)
  k0, b0 = _conv_params(rng, cin, c)
  k1, b1 = _conv_params(rng, c, c)
  jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
  tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
  stack = (jax_conv_stack.extractor_stack if c == 64
           else jax_conv_wide.wide_extractor_stack)
  want_feat, want_pool = stack(jnp.asarray(head, jdt), jnp.asarray(k0),
                               jnp.asarray(b0), jnp.asarray(k1),
                               jnp.asarray(b1), emit_pool=True,
                               interpret=True)
  got_feat, got_pool = _port_stack(head, k0, b0, k1, b1, tdt, True)
  assert got_feat.dtype == tdt and got_pool.dtype == tdt
  assert tuple(got_pool.shape) == (1, h // 2, w // 2, c)
  for got, want in ((got_feat, want_feat), (got_pool, want_pool)):
    want = np.asarray(want, np.float32)
    err = _max_abs(_np(got), want)
    if dtype == 'float32':
      assert err <= 1e-4 * np.abs(want).max(), err
    else:
      # The atol of tests/test_conv_stack.py for bf16 stacks.
      assert err <= 5e-2, err


def test_conv3x3_leaky_without_pool_and_odd_extent():
  rng = np.random.RandomState(5)
  x = (rng.rand(1, 5, 7, 64) - 0.5).astype(np.float32)
  k, b = _conv_params(rng, 64, 64)
  feat, pooled = conv_stack.conv3x3_leaky(
      _t(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
      torch.from_numpy(b))
  assert pooled is None
  y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (1, 1),
                                   'SAME', dimension_numbers=(
                                       'NHWC', 'HWIO', 'NHWC')) + b
  want = jnp.where(y >= 0, y, 0.2 * y)
  assert _max_abs(_np(feat), want) <= 1e-4 * float(jnp.abs(want).max())
  _, pooled = conv_stack.conv3x3_leaky(
      _t(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
      torch.from_numpy(b), pool=True)
  assert tuple(pooled.shape) == (1, 2, 3, 64)
  assert _max_abs(_np(pooled), jax_pyramid.avg_pool_2x(want)) <= 1e-5


def test_conv_weight_pack_is_cached_until_the_weight_changes():
  # The kernel reads K-major (Cout, 3, 3, Cin) weights in the input's dtype
  # (one packing for every route); the wrapper packs each weight once and
  # repacks only after it changes.
  weight = torch.nn.Parameter(torch.randn(64, 32, 3, 3))
  packed = conv_stack._packed_weight(weight, torch.bfloat16)
  assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
  assert tuple(packed.shape) == (64, 3, 3, 32)
  assert torch.equal(packed,
                     weight.detach().permute(0, 2, 3, 1).to(torch.bfloat16))
  assert conv_stack._packed_weight(weight, torch.bfloat16) is packed
  packed32 = conv_stack._packed_weight(weight, torch.float32)
  assert torch.equal(packed32, weight.detach().permute(0, 2, 3, 1))
  with torch.no_grad():
    weight.add_(1.0)
  repacked = conv_stack._packed_weight(weight, torch.float32)
  assert repacked is not packed32
  assert torch.equal(repacked, weight.detach().permute(0, 2, 3, 1))
  with torch.inference_mode():
    frozen = torch.randn(64, 64, 3, 3)
  assert torch.equal(conv_stack._packed_weight(frozen, torch.float32),
                     frozen.permute(0, 2, 3, 1))


@pytest.mark.parametrize('cin,cout,h,w', [(64, 64, 6, 10), (64, 128, 5, 7)])
def test_packed_weights_in_kernel_k_order_give_the_plain_conv(cin, cout, h,
                                                              w):
  # The kernel's GEMM: row m of A is output pixel m's 3x3 neighbourhood in
  # K order (tap (ky, kx) major, input channel minor, zeros off the image);
  # row n of B is the packed weights of output channel n. A @ B^T + bias,
  # then leaky, is the plain conv.
  rng = np.random.RandomState(cin + cout + h)
  x = _t((rng.rand(2, h, w, cin) - 0.5))
  k, b = _conv_params(rng, cin, cout)
  weight = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
  bias = torch.from_numpy(b)
  packed = conv_stack._packed_weight(weight, torch.float32)
  cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2), 3, padding=1)
  # unfold orders K channel-major, (Cin, 9); the kernel walks (9, Cin).
  cols = cols.reshape(2, cin, 9, h * w).permute(0, 3, 2, 1)
  y = cols.reshape(2, h * w, 9 * cin) @ packed.reshape(cout, 9 * cin).T
  y = (y + bias).reshape(2, h, w, cout)
  y = torch.where(y >= 0, y, 0.2 * y)
  want, _ = conv_stack.conv3x3_leaky_plain(x, weight, bias)
  scale = float(want.abs().max())
  assert float((y - want).abs().max()) <= 1e-5 * scale


def test_conv_route_follows_the_cudnn_tf32_flag(monkeypatch):
  # bf16 takes the wgmma entry point; f32 takes TF32 wgmma exactly when
  # torch.backends.cudnn.allow_tf32 is True, else the exact FMA kernel.
  assert conv_stack.kernel_symbol(torch.bfloat16, False) == 'fi_conv3x3_bf16'
  assert conv_stack.kernel_symbol(torch.bfloat16, True) == 'fi_conv3x3_bf16'
  assert conv_stack.kernel_symbol(torch.float32, True) == 'fi_conv3x3_tf32'
  assert conv_stack.kernel_symbol(torch.float32, False) == 'fi_conv3x3_f32'
  with pytest.raises(ValueError, match='bf16 or f32'):
    conv_stack.kernel_symbol(torch.float16, True)
  # The wrapper reads the flag at each call. Stand-ins for the library and
  # the device check record which entry point it would launch.
  called = []

  class _Library:

    def __getattr__(self, name):
      return lambda *args: called.append(name) or 0

  monkeypatch.setattr(_kernels, 'library', _Library)
  monkeypatch.setattr(_kernels, 'require_cuda', lambda *a, **k: None)
  monkeypatch.setattr(_kernels, 'stream_of', lambda t: 0)
  monkeypatch.setattr(_kernels, 'LAUNCHES', dict(_kernels.LAUNCHES))
  x = torch.zeros(1, 4, 4, 64)
  weight, bias = torch.zeros(64, 64, 3, 3), torch.zeros(64)
  for allowed in (True, False):
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', allowed)
    conv_stack.conv3x3_leaky_kernel(x, weight, bias)
    conv_stack.conv3x3_leaky_kernel(x.to(torch.bfloat16), weight, bias)
  # The exact route first asks how many parts it splits K into.
  assert called == ['fi_conv3x3_tf32', 'fi_conv3x3_bf16',
                    'fi_conv3x3_f32_splits', 'fi_conv3x3_f32',
                    'fi_conv3x3_bf16']


# ---- resize, pyramid, tiling ----------------------------------------------


@pytest.mark.parametrize('in_hw,out_hw', [((6, 10), (12, 20)),
                                          ((6, 10), (9, 17)),
                                          ((7, 5), (7, 5)),
                                          ((12, 20), (5, 7))])
def test_resize_matches_jax(in_hw, out_hw):
  rng = np.random.RandomState(11)
  x = (rng.rand(2, *in_hw, 3) * 4 - 2).astype(np.float32)
  got = resize.resize_bilinear(_t(x), out_hw)
  assert got.dtype == torch.float32
  assert _max_abs(_np(got), jax_resize.resize_bilinear(
      jnp.asarray(x), out_hw)) <= 1e-6
  got = resize.resize_nearest(_t(x, torch.bfloat16), out_hw)
  assert got.dtype == torch.bfloat16
  want = jax_resize.resize_nearest(jnp.asarray(x, jnp.bfloat16), out_hw)
  assert _max_abs(_np(got), np.asarray(want, np.float32)) == 0.0


def test_pyramid_ops_match_jax():
  rng = np.random.RandomState(12)
  image = rng.rand(2, 20, 28, 3).astype(np.float32)
  got = pyramid.build_image_pyramid(_t(image), 4)
  want = jax_pyramid.build_image_pyramid(jnp.asarray(image), 4)
  assert [tuple(g.shape) for g in got] == [w.shape for w in want]
  for g, w in zip(got, want):
    assert _max_abs(_np(g), w) <= 1e-6
  odd = rng.rand(1, 5, 7, 2).astype(np.float32)
  assert _max_abs(_np(pyramid.avg_pool_2x(_t(odd))),
                  jax_pyramid.avg_pool_2x(jnp.asarray(odd))) <= 1e-6

  residuals = [((rng.rand(2, 20 >> i, 28 >> i, 2) - 0.5) * 4).astype(
      np.float32) for i in range(3)]
  got = pyramid.flow_pyramid_synthesis([_t(r) for r in residuals])
  want = jax_pyramid.flow_pyramid_synthesis(
      [jnp.asarray(r) for r in residuals])
  for g, w in zip(got, want):
    assert _max_abs(_np(g), w) <= 1e-5

  scalar = np.array([0.5, 0.25], np.float32)
  got = pyramid.multiply_pyramid([_t(r) for r in residuals], _t(scalar))
  want = jax_pyramid.multiply_pyramid([jnp.asarray(r) for r in residuals],
                                      jnp.asarray(scalar))
  for g, w in zip(got, want):
    assert _max_abs(_np(g), w) == 0.0

  feats = [rng.rand(2, 20 >> i, 28 >> i, 4).astype(np.float32)
           for i in range(3)]
  got = pyramid.concatenate_pyramids([_t(f) for f in feats],
                                     [_t(r) for r in residuals])
  want = jax_pyramid.concatenate_pyramids(
      [jnp.asarray(f) for f in feats], [jnp.asarray(r) for r in residuals])
  for g, w in zip(got, want):
    assert _max_abs(_np(g), w) == 0.0
  got = pyramid.pyramid_warp([_t(f) for f in feats],
                             [_t(r) for r in residuals])
  want = jax_pyramid.pyramid_warp([jnp.asarray(f) for f in feats],
                                  [jnp.asarray(r) for r in residuals])
  for g, w in zip(got, want):
    assert _max_abs(_np(g), w) <= 1e-5


@pytest.mark.parametrize('h,w,align', [(37, 53, 16), (64, 64, 64),
                                       (30, 70, 8)])
def test_tiling_matches_jax(h, w, align):
  rng = np.random.RandomState(13)
  x = rng.rand(1, h, w, 3).astype(np.float32)
  got, got_box = tiling.pad_to_align(_t(x), align)
  want, want_box = jax_tiling.pad_to_align(jnp.asarray(x), align)
  assert got_box == want_box
  assert _max_abs(_np(got), want) == 0.0
  back = tiling.crop_to_bounding_box(got, **got_box)
  assert _max_abs(_np(back), x) == 0.0
  block = (2, 2)
  patches = tiling.image_to_patches(got, block)
  want_patches = jax_tiling.image_to_patches(want, block)
  assert _max_abs(_np(patches), want_patches) == 0.0
  assert _max_abs(_np(tiling.patches_to_image(patches, block)), want) == 0.0


# ---- import hygiene ----------------------------------------------------------


def test_port_imports_without_jax_flax_absl_pil():
  script = textwrap.dedent("""
      import importlib, pkgutil, sys
      blocked = ('jax', 'jaxlib', 'flax', 'absl', 'PIL', 'msgpack',
                 'tensorflow', 'google', 'frame_interpolation_tpu')

      class Block:
        def find_spec(self, name, path=None, target=None):
          if name.split('.')[0] in blocked:
            raise ImportError(f'blocked import of {name}')
          return None

      # A site's namespace-package .pth files may load `google` at start
      # up: only modules imported after the block count.
      preloaded = set(sys.modules)
      sys.meta_path.insert(0, Block())
      # Importing starts no compiler (the kernels and the native CRC are
      # built at first use): no process may start while modules import.
      import subprocess
      started = []
      real_popen_init = subprocess.Popen.__init__

      def recording_init(self, *args, **kwargs):
        started.append(args[0] if args else kwargs.get('args'))
        real_popen_init(self, *args, **kwargs)

      subprocess.Popen.__init__ = recording_init
      import frame_interpolation_tpu_torch as pkg
      names = []
      for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
        # The cog adapter needs the cog runtime, which only its container
        # has (tests/test_torch_serving.py parses it).
        if info.name.endswith('.serving.cog_predict'):
          continue
        importlib.import_module(info.name)
        names.append(info.name)
      assert 'jax' not in sys.modules
      assert not any(m.split('.')[0] in blocked
                     for m in set(sys.modules) - preloaded)
      assert started == [], started
      for name in ('cli._common', 'cli.build_params',
                   'cli.verify_released',
                   'cli.create_middlebury_tfrecord',
                   'cli.create_ucf101_tfrecord',
                   'cli.create_vimeo90K_tfrecord',
                   'cli.create_xiph_tfrecord', 'cli.eval_benchmark',
                   'cli.interpolate_dir', 'cli.interpolate_pair',
                   'cli.train', 'data.augmentations',
                   'data.builders.triplets', 'data.dataset',
                   'data.example_proto', 'data.records', 'data.tfrecord',
                   'inference.cached_tree', 'inference.recursion',
                   'io.msgpack_lite', 'io.params_io', 'io.tf_bundle',
                   'io.tf_import', 'io.video',
                   'losses.losses', 'losses.vgg19', 'native',
                   'ops.image_metrics', 'ops.rows', 'parallel.distributed',
                   'parallel.inference', 'parallel.mesh',
                   'parallel.shard_map', 'serving.predictor',
                   'training.configs',
                   'training.configs.gin_compat', 'training.eval_lib',
                   'training.metrics_lib', 'training.sources',
                   'training.train_lib', 'utils.fanout',
                   'utils.profiling', 'utils.tensorboard'):
        assert pkg.__name__ + '.' + name in names, name
      print(len(names))
      """)
  proc = subprocess.run([sys.executable, '-c', script], capture_output=True,
                        text=True, check=False, timeout=120,
                        cwd=pathlib.Path(__file__).resolve().parent.parent)
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.strip()) >= 70
