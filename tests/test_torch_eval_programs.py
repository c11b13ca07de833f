"""Eval and the all-outputs forward as programs, on the CPU.

On the card, eval's forward and metrics are one captured program a batch
shape and `Interpolator.interpolate_all_outputs` the Interpolator's fifth
program; on the CPU both run the same functions eagerly. Held here: eval's
means from the stacked metrics against the JAX package's `eval_loop` on
the same weights and triplets (1e-4 relative, test_torch_eval.py's
bound), with one host read a batch and no per-metric `float()`; every
output of `interpolate_all_outputs` against JAX's `_forward_all`; and
graphs=True on the CPU refused. Two JAX compiles for eval (forward and
metrics at one batch shape), one for the all-outputs forward.
"""
import numpy as np
import pytest
import torch

from frame_interpolation_tpu import losses as jax_losses
from frame_interpolation_tpu.inference import interpolator as jax_interp
from frame_interpolation_tpu.models import film_net as jax_film_net
from frame_interpolation_tpu.options import Options as JaxOptions
from frame_interpolation_tpu.training import eval_lib as jax_eval_lib
from frame_interpolation_tpu.training import metrics_lib as jax_metrics_lib
from frame_interpolation_tpu_torch import losses
from frame_interpolation_tpu_torch.inference import Interpolator
from frame_interpolation_tpu_torch.io import params_io
from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.training import eval_lib, metrics_lib

torch.set_num_threads(2)

REL_BOUND = 1e-4
# Every output of the forward, port vs JAX in f32: the flows reach a few
# pixels and the images lie in [0, 1]; the forwards agree to about 1e-6
# of that (the Interpolator's parity test holds the image to 1e-4).
ALL_OUTPUTS_ATOL = 1e-4
H, W = 32, 48


@pytest.fixture(scope='module')
def tiny_state():
  rng = np.random.RandomState(4)
  state = {}
  for name, value in film_net.create_model(Options.tiny()).state_dict(
      ).items():
    if value.dim() == 4:
      array = rng.randn(*value.shape) * np.prod(value.shape[1:])**-0.5
    else:
      array = rng.randn(*value.shape) * 0.1
    state[name] = torch.from_numpy(array.astype(np.float32))
  return state


def _batch(seed, n=2):
  rng = np.random.RandomState(seed)
  frames = rng.rand(3, n, H, W, 3).astype(np.float32)
  return {'x0': frames[0], 'y': frames[1], 'x1': frames[2],
          'time': np.full((n, 1), 0.5, np.float32)}


def _metric_fns():
  test = ['l1', 'l2', 'ssim', 'psnr']
  weights = [1.0, 2.0, 1.0, 0.5]
  return (metrics_lib.create_metrics_fns(
              losses.test_losses(test, loss_weights=weights),
              losses.training_losses(['l1', 'l2'], loss_weights=[1.0, 0.25])),
          jax_metrics_lib.create_metrics_fns(
              jax_losses.test_losses(test, loss_weights=weights),
              jax_losses.training_losses(['l1', 'l2'],
                                         loss_weights=[1.0, 0.25])))


def _no_scalar_read(*args):
  raise AssertionError('a metric was read on its own')


def test_eval_means_match_jax_with_one_host_read_a_batch(tiny_state,
                                                         monkeypatch):
  datasets = {'a': [_batch(2), _batch(3)], 'b': [_batch(4), _batch(5),
                                                 _batch(6)]}
  ours, theirs = _metric_fns()
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(tiny_state)
  reads = []
  tolist = torch.Tensor.tolist

  def counted(self):
    reads.append(tuple(self.shape))
    return tolist(self)

  with monkeypatch.context() as m:
    m.setattr(torch.Tensor, 'tolist', counted)
    m.setattr(torch.Tensor, 'item', _no_scalar_read)
    m.setattr(torch.Tensor, '__float__', _no_scalar_read)
    got = eval_lib.eval_loop(model, datasets, ours, 11,
                             log_fn=lambda _: None)
  # One read of the stacked metrics a batch, one value a metric.
  assert reads == [(len(ours),)] * 5
  want = jax_eval_lib.eval_loop(
      jax_film_net.FilmNet(JaxOptions.tiny()),
      params_io.to_flax_params(tiny_state), datasets, theirs, 11,
      log_fn=lambda _: None)
  assert got.keys() == want.keys()
  for name in want:
    assert list(got[name]) == list(ours)
    for metric, value in want[name].items():
      assert abs(got[name][metric] - value) <= REL_BOUND * abs(value), (
          name, metric)


def test_eval_summary_grids_come_from_the_returned_prediction(tiny_state):
  # The grid of a batch is x0 | clipped prediction | y | x1, read from what
  # the (program's) call returned.
  model = film_net.create_model(Options.tiny())
  model.load_state_dict(tiny_state)
  images = {}

  class Writer:

    def image(self, tag, image, step):
      images[tag] = np.asarray(image)

    def scalar(self, tag, value, step):
      pass

  batch = _batch(7)
  ours, _ = _metric_fns()
  eval_lib.eval_loop(model, {'a': [batch, _batch(8)]}, ours, 3,
                     writer=Writer(), max_summary_batches=1,
                     log_fn=lambda _: None)
  assert list(images) == ['eval/a/x0_pred_y_x1_0']
  with torch.no_grad():
    pred = model(*(torch.from_numpy(batch[k]) for k in ('x0', 'x1', 'time'))
                 )['image'][0].clamp(0.0, 1.0).numpy()
  grid = images['eval/a/x0_pred_y_x1_0']
  np.testing.assert_array_equal(grid[:, :W], batch['x0'][0])
  np.testing.assert_allclose(grid[:, W:2 * W], pred, rtol=0, atol=1e-6)
  np.testing.assert_array_equal(grid[:, 3 * W:], batch['x1'][0])


def test_eval_graphs_true_on_the_cpu_raises(tiny_state):
  model = film_net.create_model(Options.tiny())
  ours, _ = _metric_fns()
  with pytest.raises(ValueError, match='graphs=True needs a CUDA device'):
    eval_lib.eval_loop(model, {'a': [_batch(1)]}, ours, 0,
                       log_fn=lambda _: None, graphs=True)


def _flat_outputs(outputs):
  """name -> array of every output, pyramids by level."""
  flat = {}
  for name, value in outputs.items():
    if isinstance(value, (list, tuple)):
      for level, v in enumerate(value):
        flat[f'{name}/{level}'] = np.asarray(v)
    else:
      flat[name] = np.asarray(value)
  return flat


def test_interpolate_all_outputs_matches_jax_forward_all(tiny_state):
  rng = np.random.RandomState(9)
  x0 = rng.rand(1, 37, 53, 3).astype(np.float32)
  x1 = rng.rand(1, 37, 53, 3).astype(np.float32)
  dt = np.full((1,), 0.5, np.float32)
  want = _flat_outputs(jax_interp.Interpolator(
      params_io.to_flax_params(tiny_state), JaxOptions.tiny(),
      align=16).interpolate_all_outputs(x0, x1, dt))
  interp = Interpolator(tiny_state, Options.tiny(), align=16, device='cpu')
  got = interp.interpolate_all_outputs(x0, x1, dt)
  got = _flat_outputs({k: (v.numpy() if isinstance(v, torch.Tensor) else
                           [t.numpy() for t in v]) for k, v in got.items()})
  assert got.keys() == want.keys()
  # Only the image is cropped; the aux outputs stay at the padded size.
  assert got['image'].shape == (1, 37, 53, 3)
  assert got['x0_warped'].shape == (1, 48, 64, 3)
  for name in want:
    assert got[name].shape == want[name].shape, name
    np.testing.assert_allclose(got[name], want[name], rtol=0,
                               atol=ALL_OUTPUTS_ATOL, err_msg=name)
  # The image equals the pair entry point's.
  np.testing.assert_array_equal(got['image'], interp(x0, x1, dt))
