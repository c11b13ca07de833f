"""The PyTorch port's warp and conv gradients against the JAX package's.

The port writes out the warp's gradient as the JAX window VJP does
(derivative planes for the flow, a splat for the image) and differentiates
its fused conv as the JAX custom VJP does (the unfused composition). Here
the same numpy inputs go through `jax.vjp` of the JAX functions and through
torch autograd of the port's, on the CPU, where the port's wrappers run
their plain versions. The TPU kernels run as their own tests run them:
Pallas in interpret mode.

The kernels' route (what a CUDA tensor takes) is exercised here too, with
the kernels stood in for by their plain versions run without autograd, as
the ctypes kernels run: its gradients must equal the plain route's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frame_interpolation_tpu.ops import conv_stack as jax_conv_stack
from frame_interpolation_tpu.ops import warp as jax_warp
from frame_interpolation_tpu.ops import warp_splat as jax_warp_splat
from frame_interpolation_tpu.ops import warp_window as jax_warp_window
from frame_interpolation_tpu_torch.models import layers
from frame_interpolation_tpu_torch.ops import conv_stack, warp

torch.set_num_threads(2)


def _t(a, requires_grad=False):
  t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
  return t.requires_grad_(requires_grad)


def _max_abs(a, b):
  return float(np.max(np.abs(np.asarray(a, np.float32) -
                             np.asarray(b, np.float32))))


# name -> (batch, h, w, c, flow kind)
_CASES = {
    'zero': (1, 12, 20, 3, 'zero'),
    'integer': (1, 12, 20, 3, 'integer'),
    'out_of_bounds': (1, 12, 20, 3, 'oob'),
    'random': (1, 16, 24, 4, 'random'),
    'odd_c': (1, 10, 14, 67, 'random'),
    'batch2': (2, 12, 20, 3, 'random'),
    'coarse4': (2, 4, 4, 8, 'random'),
    'coarse8': (1, 8, 8, 8, 'random'),
    'coarse16': (1, 16, 16, 8, 'integer'),
    'coarse32': (1, 32, 32, 8, 'random'),
    # The widths and flows of the kernels' odd-C routes: the second fusion
    # width with every offset on the clip's tie, the first with most taps
    # clamped.
    'c195_integer': (1, 6, 10, 195, 'integer'),
    'c67_oob': (1, 10, 14, 67, 'oob'),
}


def _case(name, seed=0):
  b, h, w, c, kind = _CASES[name]
  rng = np.random.RandomState(seed)
  image = rng.rand(b, h, w, c).astype(np.float32)
  g = (rng.rand(b, h, w, c) - 0.5).astype(np.float32)
  if kind == 'zero':
    flow = np.zeros((b, h, w, 2), np.float32)
  elif kind == 'integer':
    # Every raw offset is exactly 0, and the last row and column sit at
    # exactly 1: the clip gradient's 0.5 ties everywhere.
    flow = rng.randint(-3, 4, size=(b, h, w, 2)).astype(np.float32)
  elif kind == 'oob':
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 60.0).astype(np.float32)
  else:
    flow = ((rng.rand(b, h, w, 2) - 0.5) * 6.0).astype(np.float32)
  return image, flow, g


def _jax_vjp(fn, image, flow, g):
  _, vjp = jax.vjp(fn, jnp.asarray(image), jnp.asarray(flow))
  return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_vjp(image, flow, g, warp_fn=warp.backward_warp):
  ti, tf = _t(image, True), _t(flow, True)
  out = warp_fn(ti, tf)
  out.backward(_t(g))
  return ti.grad.numpy(), tf.grad.numpy()


@pytest.mark.parametrize('name', list(_CASES))
def test_warp_vjp_matches_jax(name):
  image, flow, g = _case(name)
  want_image, want_flow = _jax_vjp(jax_warp.backward_warp, image, flow, g)
  got_image, got_flow = _port_vjp(image, flow, g)
  assert _max_abs(got_flow, want_flow) <= 1e-5
  # Many taps land on one clamped corner out of bounds: the f32 sums there
  # grow with their count, so the bound scales with the magnitude.
  assert _max_abs(got_image, want_image) <= 1e-5 * max(
      1.0, float(np.abs(want_image).max()))


def test_warp_vjp_is_not_autograd_of_the_clamp():
  # The clip gradient's tie: autograd of the plain forward passes 1 where
  # the raw offset is exactly 0 or 1 (torch.clamp), JAX passes 0.5. With
  # an integer flow every pixel sits on a tie.
  image, flow, g = _case('integer')
  got = _port_vjp(image, flow, g)[1]
  autograd = _port_vjp(image, flow, g, warp.backward_warp_plain)[1]
  want = _jax_vjp(jax_warp.backward_warp, image, flow, g)[1]
  assert _max_abs(got, want) <= 1e-5
  assert _max_abs(autograd, want) > 1e-2


def test_warp_vjp_matches_window_kernel_interpret():
  image, flow, g = _case('random', seed=1)
  want_image, want_flow = _jax_vjp(
      lambda i, f: jax_warp_window.backward_warp_window(i, f, True),
      image, flow, g)
  got_image, got_flow = _port_vjp(image, flow, g)
  assert _max_abs(got_flow, want_flow) <= 1e-5
  assert _max_abs(got_image, want_image) <= 1e-5


@pytest.mark.parametrize('name', ['integer', 'out_of_bounds', 'odd_c',
                                  'batch2', 'c195_integer', 'c67_oob'])
def test_warp_planes_plain_matches_jax(name):
  image, flow, _ = _case(name)
  _, want_du, want_dv = jax_warp._raw_and_planes(jnp.asarray(image),
                                                 jnp.asarray(flow))
  du, dv = warp.warp_planes_plain(_t(image), _t(flow))
  assert du.dtype == dv.dtype == torch.float32
  assert _max_abs(du.numpy(), want_du) <= 1e-6
  assert _max_abs(dv.numpy(), want_dv) <= 1e-6


def test_warp_planes_plain_bf16_rounds_once():
  image, flow, _ = _case('random')
  image16 = _t(image).to(torch.bfloat16)
  du, dv = warp.warp_planes_plain(image16, _t(flow))
  assert du.dtype == dv.dtype == torch.bfloat16
  want_du, want_dv = warp.warp_planes_plain(image16.float(), _t(flow))
  # One rounding of each f32 plane (|du|, |dv| < 1): half a bf16 ulp.
  assert _max_abs(du.float().numpy(), want_du.numpy()) <= 2.0**-9
  assert _max_abs(dv.float().numpy(), want_dv.numpy()) <= 2.0**-9


@pytest.mark.parametrize('name', ['random', 'out_of_bounds', 'batch2',
                                  'odd_c', 'c195_integer', 'c67_oob'])
def test_splat_plain_matches_window_splat_interpret(name):
  _, flow, g = _case(name)
  want = jax_warp_splat.backward_warp_splat(jnp.asarray(g), jnp.asarray(flow),
                                            interpret=True)
  got = warp.splat_plain(_t(g), _t(flow))
  assert got.dtype == torch.float32
  want = np.asarray(want)
  assert _max_abs(got.numpy(), want) <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize('name', ['coarse4', 'coarse8', 'coarse16',
                                  'coarse32'])
def test_splat_plain_matches_small_splat(name):
  # The coarse shapes the JAX package routes to the dense matmul splat.
  _, flow, g = _case(name)
  want = jax_warp_splat.backward_warp_splat_small(jnp.asarray(g),
                                                  jnp.asarray(flow))
  got = warp.splat_plain(_t(g), _t(flow))
  assert _max_abs(got.numpy(), want) <= 1e-5


def test_splat_plain_matches_resident_splat_interpret():
  _, flow, g = _case('random', seed=2)
  want = jax_warp_splat.backward_warp_splat_resident(
      jnp.asarray(g), jnp.asarray(flow), interpret=True)
  got = warp.splat_plain(_t(g), _t(flow))
  assert _max_abs(got.numpy(), want) <= 1e-5


def _kernel_stand_ins(monkeypatch, module, names):
  """Replaces kernel wrappers with their plain versions run without
  autograd (as the ctypes kernels run), counting the calls."""
  calls = {name: 0 for name in names}

  def stand_in(name, plain):
    def fn(*args, **kwargs):
      calls[name] += 1
      with torch.no_grad():
        return plain(*args, **kwargs)
    return fn

  for name, plain in names.items():
    monkeypatch.setattr(module, name, stand_in(name, plain))
  return calls


def test_kernel_route_of_the_warp_carries_gradients(monkeypatch):
  # A CUDA tensor takes BackwardWarp with plain=False: the forward, planes
  # and splat kernels write fresh tensors with no autograd history, so the
  # gradient must come from the Function.
  image, flow, g = _case('out_of_bounds')
  want = _port_vjp(image, flow, g)
  calls = _kernel_stand_ins(monkeypatch, warp, {
      'backward_warp_kernel': warp.backward_warp_plain,
      'warp_planes_kernel': warp.warp_planes_plain,
      'splat_kernel': warp.splat_plain})
  got = _port_vjp(image, flow, g,
                  lambda i, f: warp.BackwardWarp.apply(i, f, False))
  assert calls == {'backward_warp_kernel': 1, 'warp_planes_kernel': 1,
                   'splat_kernel': 1}
  for a, b in zip(got, want):
    assert _max_abs(a, b) == 0.0


# ---- leaky relu and the conv Function ----------------------------------------


def test_leaky_relu_gradient_at_zero_matches_jax():
  x = np.array([0.0, -1.0, 1.0, -0.0], np.float32)
  want = jax.grad(lambda v: jnp.sum(jax.nn.leaky_relu(v, 0.2)))(
      jnp.asarray(x))
  tx = _t(x, True)
  layers.leaky_relu(tx).sum().backward()
  np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
  np.testing.assert_array_equal(layers.leaky_relu(_t(x)).numpy(),
                                np.asarray(jax.nn.leaky_relu(x, 0.2)))


def _conv_inputs(seed, cin, cout, h=8, w=10, zero_bias=True):
  rng = np.random.RandomState(seed)
  x = (rng.rand(2, h, w, cin) - 0.5).astype(np.float32)
  # An all-zero region with a zero bias puts exact zeros before the leaky
  # relu: its tie.
  x[:, :h // 2, :w // 2] = 0.0
  kernel = ((rng.rand(3, 3, cin, cout) - 0.5) * 0.3).astype(np.float32)
  bias = (np.zeros(cout) if zero_bias else rng.rand(cout) - 0.5).astype(
      np.float32)
  return x, kernel, bias


def _jax_conv_vjp(x, kernel, bias, pool, cts):
  def fn(x, k, b):
    # The composition the JAX custom VJP differentiates (one conv).
    y = jax.lax.conv_general_dilated(
        x, k, (1, 1), 'SAME', dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    y = y + b[None, None, None]
    y = jnp.where(y >= 0, y, y * 0.2)
    if pool:
      from frame_interpolation_tpu.ops import pyramid
      return y, pyramid.avg_pool_2x(y)
    return y

  out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(kernel),
                     jnp.asarray(bias))
  cts = tuple(jnp.asarray(c) for c in cts)
  return out, [np.asarray(v) for v in vjp(cts if pool else cts[0])]


def _port_conv_vjp(x, kernel, bias, pool, cts, conv=conv_stack.conv3x3_leaky):
  tx = _t(x, True)
  tw = _t(kernel.transpose(3, 2, 0, 1), True)
  tb = _t(bias, True)
  feat, pooled = conv(tx, tw, tb, pool)
  loss = (feat * _t(cts[0])).sum()
  if pool:
    loss = loss + (pooled * _t(cts[1])).sum()
  loss.backward()
  return (tx.grad.numpy(), tw.grad.numpy().transpose(2, 3, 1, 0),
          tb.grad.numpy())


@pytest.mark.parametrize('pool,h,w', [(True, 8, 10), (True, 7, 9),
                                      (False, 8, 10)],
                         ids=['pool', 'pool_odd', 'no_pool'])
def test_conv_function_grads_match_jax(pool, h, w):
  x, kernel, bias = _conv_inputs(1, 8, 16, h, w)
  rng = np.random.RandomState(2)
  cts = [(rng.rand(2, h, w, 16) - 0.5).astype(np.float32),
         (rng.rand(2, h // 2, w // 2, 16) - 0.5).astype(np.float32)]
  _, want = _jax_conv_vjp(x, kernel, bias, pool, cts)
  got = _port_conv_vjp(x, kernel, bias, pool, cts)
  for a, b in zip(got, want):
    assert _max_abs(a, b) <= 1e-5 * max(1.0, float(np.abs(b).max()))


def test_conv_function_grads_match_jax_fused_stack_interpret():
  # Against the JAX package's own fused stack (interpret mode) and its
  # custom VJP: the second conv of a C=64 sub-level, with the pool.
  rng = np.random.RandomState(3)
  head = (rng.rand(1, 6, 8, 3) - 0.5).astype(np.float32)
  head[:, :3] = 0.0
  k0 = ((rng.rand(3, 3, 3, 64) - 0.5) * 0.3).astype(np.float32)
  k1 = ((rng.rand(3, 3, 64, 64) - 0.5) * 0.1).astype(np.float32)
  b0 = np.zeros(64, np.float32)
  b1 = np.zeros(64, np.float32)
  cts = [(rng.rand(1, 6, 8, 64) - 0.5).astype(np.float32),
         (rng.rand(1, 3, 4, 64) - 0.5).astype(np.float32)]

  def jax_fn(head, k0, b0, k1, b1):
    return jax_conv_stack.extractor_stack(head, k0, b0, k1, b1,
                                          emit_pool=True, interpret=True)

  _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (head, k0, b0, k1, b1)))
  want = [np.asarray(v) for v in vjp(tuple(map(jnp.asarray, cts)))]

  th = _t(head, True)
  w0 = _t(k0.transpose(3, 2, 0, 1), True)
  w1 = _t(k1.transpose(3, 2, 0, 1), True)
  tb0, tb1 = _t(b0, True), _t(b1, True)
  y0 = torch.nn.functional.conv2d(th.permute(0, 3, 1, 2), w0, tb0, padding=1)
  y0 = layers.leaky_relu(y0.permute(0, 2, 3, 1))
  feat, pooled = conv_stack.conv3x3_leaky(y0, w1, tb1, pool=True)
  ((feat * _t(cts[0])).sum() + (pooled * _t(cts[1])).sum()).backward()
  got = [th.grad.numpy(), w0.grad.numpy().transpose(2, 3, 1, 0),
         tb0.grad.numpy(), w1.grad.numpy().transpose(2, 3, 1, 0),
         tb1.grad.numpy()]
  for a, b in zip(got, want):
    assert _max_abs(a, b) <= 1e-5 * max(1.0, float(np.abs(b).max()))


def test_kernel_route_of_the_conv_carries_gradients(monkeypatch):
  x, kernel, bias = _conv_inputs(4, 8, 16, zero_bias=False)
  rng = np.random.RandomState(5)
  cts = [(rng.rand(2, 8, 10, 16) - 0.5).astype(np.float32),
         (rng.rand(2, 4, 5, 16) - 0.5).astype(np.float32)]
  want = _port_conv_vjp(x, kernel, bias, True, cts)
  calls = _kernel_stand_ins(monkeypatch, conv_stack, {
      'conv3x3_leaky_kernel': conv_stack.conv3x3_leaky_plain})

  def kernel_route(x, w, b, pool):
    return conv_stack.Conv3x3Leaky.apply(x, w, b, pool, 0.2, False)

  got = _port_conv_vjp(x, kernel, bias, True, cts, kernel_route)
  assert calls == {'conv3x3_leaky_kernel': 1}
  for a, b in zip(got, want):
    assert _max_abs(a, b) == 0.0


def test_non_cpu_tensors_take_the_autograd_functions(monkeypatch):
  # backward_warp and conv3x3_leaky send every tensor that is not on the
  # CPU to the kernels inside the autograd Functions, so the result carries
  # the Function's gradient. Meta tensors stand in for CUDA ones here, the
  # kernels for plain versions run without autograd.
  warp_calls = _kernel_stand_ins(monkeypatch, warp, {
      'backward_warp_kernel': warp.backward_warp_plain})
  conv_calls = _kernel_stand_ins(monkeypatch, conv_stack, {
      'conv3x3_leaky_kernel': conv_stack.conv3x3_leaky_plain})
  image = torch.zeros(1, 4, 6, 64, device='meta', requires_grad=True)
  flow = torch.zeros(1, 4, 6, 2, device='meta', requires_grad=True)
  out = warp.backward_warp(image, flow)
  assert type(out.grad_fn).__name__ == 'BackwardWarpBackward'
  weight = torch.zeros(64, 64, 3, 3, device='meta', requires_grad=True)
  bias = torch.zeros(64, device='meta', requires_grad=True)
  feat, pooled = conv_stack.conv3x3_leaky(out, weight, bias, pool=True)
  assert type(feat.grad_fn).__name__ == 'Conv3x3LeakyBackward'
  assert pooled.grad_fn is feat.grad_fn
  assert warp_calls == {'backward_warp_kernel': 1}
  assert conv_calls == {'conv3x3_leaky_kernel': 1}
