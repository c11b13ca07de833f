"""The harness with the timed path broken underneath sees `correct` come
out false: a run on the CPU at a tiny size, past the look for a card,
once for each fault a cell can have (one chip: no exchange to leave out).
"""
import torch

from film_bench.tests import helpers


def _correct(cell, seconds=2.0):
  ctx = helpers.context(cell, seconds=seconds)
  outcome, checks = helpers.drive(ctx)
  return outcome['failed'] == 0 and all(v <= limit for _, v, limit in checks)


def test_pair_answer_altered(monkeypatch):
  from frame_interpolation_tpu_torch.inference import Interpolator
  call = Interpolator.__call__

  def altered(self, x0, x1, dt):
    out = call(self, x0, x1, dt)
    out[0, :8, :8] += 0.25  # a patch of the answer wrong
    return out

  monkeypatch.setattr(Interpolator, '__call__', altered)
  assert not _correct('pair-1080p')


def test_video_answer_altered(monkeypatch):
  from frame_interpolation_tpu_torch.inference import cached_tree
  quantize = cached_tree.quantize_u8

  def altered(x):
    out = quantize(x).clone()
    out[..., :4, :4, 0] ^= 0x40  # a patch of every frame wrong
    return out

  monkeypatch.setattr(cached_tree, 'quantize_u8', altered)
  assert not _correct('video-1080p-t3')


def test_video_state_unchanged(monkeypatch):
  from frame_interpolation_tpu_torch.inference import Interpolator
  tree_pair = Interpolator.tree_pair_device

  def stale(self, left, right_frame, times, as_uint8=False):
    mids, _ = tree_pair(self, left, right_frame, times, as_uint8)
    return mids, left  # the next pair starts from a stale frame's features

  monkeypatch.setattr(Interpolator, 'tree_pair_device', stale)
  assert not _correct('video-1080p-t3')


def test_train_state_unchanged(monkeypatch, tiny_vgg):
  from frame_interpolation_tpu_torch.training import train_lib
  make = train_lib.make_train_step

  def unchanged(*args, **kwargs):
    step = make(*args, **kwargs)

    def run(state, batch, generator):
      saved = [p.detach().clone() for p in state.model.parameters()]
      out = step(state, batch, generator)
      with torch.no_grad():
        for p, s in zip(state.model.parameters(), saved):
          p.copy_(s)
      return out

    run.programs = step.programs
    return run

  monkeypatch.setattr(train_lib, 'make_train_step', unchanged)
  assert not _correct('train-style-256', seconds=0.5)


def test_train_half_batch(monkeypatch, tiny_vgg):
  from frame_interpolation_tpu_torch.training import train_lib
  to_device = train_lib.batch_to_device

  def half(batch, device):
    return {k: v[:v.shape[0] // 2] for k, v in to_device(batch,
                                                         device).items()}

  monkeypatch.setattr(train_lib, 'batch_to_device', half)
  assert not _correct('train-style-256', seconds=0.5)


def test_train_half_batch_in_the_replays(monkeypatch, tiny_vgg):
  """Half the batch left out from the second step on, where the card
  replays the captured step: the first step's numbers cannot see it, the
  replays' own do."""
  from frame_interpolation_tpu_torch.training import train_lib
  to_device = train_lib.batch_to_device
  calls = []

  def half_after_the_first(batch, device):
    calls.append(None)
    out = to_device(batch, device)
    if len(calls) == 1:
      return out
    return {k: v[:v.shape[0] // 2] for k, v in out.items()}

  monkeypatch.setattr(train_lib, 'batch_to_device', half_after_the_first)
  ctx = helpers.context('train-style-256', seconds=0.5)
  outcome, checks = helpers.drive(ctx)
  checks = {name: (value, limit) for name, value, limit in checks}
  for name in ('first_loss_gap', 'grad_norm_gap_median'):
    assert checks[name][0] <= checks[name][1], checks
  assert not all(v <= limit for v, limit in checks.values()), checks
  assert (checks['replay_loss_gap'][0] > checks['replay_loss_gap'][1] or
          checks['replay1_grad_norm_gap_median'][0] >
          checks['replay1_grad_norm_gap_median'][1]), checks
