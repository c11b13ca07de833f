"""The film_net-Style step in plain PyTorch: the benchmark's reference.

From the published recipe (google-research/frame-interpolation,
training/config/film_net-Style.gin, losses/losses.py, losses/vgg19_loss.py,
training/augmentation_lib.py), with no kernel, graph or shared tower:

  * the four augmentations, one draw per example from a torch.Generator
    on the host, in the gin's order: rot90 (k in 0..3), a left-right flip
    (a coin), a rotation (a coin, then u ~ U[0, 1) for the angle
    (u / 2 - 1 / 4) * pi, bilinear about the centre with zero fill) and a
    temporal reverse (a coin swaps x0 and x1);
  * l1 = mean |pred - y|;
  * VGG-19 to conv5_2 on [0, 255] inputs less the ImageNet mean, ReLU
    after every conv, 2x2 SAME average pools after conv{1,2}_2 and
    conv{3,4}_4; vgg = sum_i w_i mean |F_i(y) - F_i(pred)| / 255 and
    style = sum_i w_i mean (G(F_i(y) / 255) - G(F_i(pred) / 255))^2, with
    G(F) = F F^T / (h w) and w = (1/2.6, 1/4.8, 1/3.7, 1/5.6, 10/1.5) over
    conv{1..5}_2; y's towers carry no gradient;
  * Adam (beta 0.9, 0.999, epsilon 1e-7, the learning rate given).

Every conv and the Gram products run in float32 as the switches outside
say (the caller turns TF32 off, and may hand the convs to cuDNN's TF32,
tf32_convs.py), unless a `quant` is given (lowp.py): it then rounds each
conv's and each Gram product's operands first, forward and backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import film_net

VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512, 512)
VGG_NAMES = ('conv1_1', 'conv1_2', 'conv2_1', 'conv2_2', 'conv3_1',
             'conv3_2', 'conv3_3', 'conv3_4', 'conv4_1', 'conv4_2',
             'conv4_3', 'conv4_4', 'conv5_1', 'conv5_2')
POOL_AFTER = ('conv1_2', 'conv2_2', 'conv3_4', 'conv4_4')
LOSS_LAYERS = ('conv1_2', 'conv2_2', 'conv3_2', 'conv4_2', 'conv5_2')
LAYER_WEIGHTS = (1.0 / 2.6, 1.0 / 4.8, 1.0 / 3.7, 1.0 / 5.6, 10.0 / 1.5)
IMAGENET_MEAN = (123.68, 116.779, 103.939)
BETAS, EPSILON = (0.9, 0.999), 1e-7


# ---- augmentations -----------------------------------------------------------


def draw(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
  """One step's draws, in the order they are made."""
  k = torch.randint(0, 4, (batch,), generator=generator)
  flip = torch.randint(0, 2, (batch,), generator=generator)
  rotate = torch.randint(0, 2, (batch,), generator=generator)
  u = torch.rand((batch,), generator=generator)
  reverse = torch.randint(0, 2, (batch,), generator=generator)
  return {'k': k, 'flip': flip, 'rotate': rotate, 'u': u,
          'reverse': reverse}


def _rotate(images: torch.Tensor, angle: float) -> torch.Tensor:
  """(N, C, H, W) turned counter-clockwise by `angle` about the centre."""
  n, _, h, w = images.shape
  cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
  cos = torch.cos(torch.tensor(angle, dtype=torch.float32))
  sin = torch.sin(torch.tensor(angle, dtype=torch.float32))
  gy = torch.arange(h, dtype=torch.float32)[:, None] - cy
  gx = torch.arange(w, dtype=torch.float32)[None, :] - cx
  qx = (cos * gx - sin * gy + cx) * (2.0 / (w - 1)) - 1.0
  qy = (sin * gx + cos * gy + cy) * (2.0 / (h - 1)) - 1.0
  grid = torch.stack([qx, qy], -1).to(images.device)[None].expand(n, h, w, 2)
  return F.grid_sample(images, grid, mode='bilinear', padding_mode='zeros',
                       align_corners=True)


def augment(batch: Dict[str, torch.Tensor],
            draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """Applies one step's draws to NCHW 'x0', 'x1', 'y', example by
  example."""
  out = {key: [] for key in ('x0', 'x1', 'y')}
  for b in range(batch['y'].shape[0]):
    images = torch.stack([batch[key][b] for key in ('x0', 'x1', 'y')])
    images = torch.rot90(images, int(draws['k'][b]), dims=(2, 3))
    if draws['flip'][b]:
      images = images.flip(3)
    angle = (float(draws['u'][b]) * 0.5 - 0.25) * math.pi
    images = _rotate(images, angle * int(draws['rotate'][b]))
    if draws['reverse'][b]:
      images = images[[1, 0, 2]]
    for i, key in enumerate(('x0', 'x1', 'y')):
      out[key].append(images[i])
  return {key: torch.stack(values) for key, values in out.items()}


# ---- losses ------------------------------------------------------------------


def vgg_features(weights: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 image: torch.Tensor, quant=None) -> Dict[str, torch.Tensor]:
  """Conv outputs by layer of an NCHW [0, 1] image. `weights`: 14 (OIHW
  kernel, bias) pairs."""
  mean = torch.tensor(IMAGENET_MEAN, device=image.device).reshape(1, 3, 1, 1)
  net = image * 255.0 - mean
  feats = {}
  for (kernel, bias), name in zip(weights, VGG_NAMES):
    net = F.relu(film_net.conv2d(net, kernel, bias, 1, quant))
    feats[name] = net
    if name in POOL_AFTER:
      net = F.avg_pool2d(net, 2, 2, ceil_mode=True, count_include_pad=False)
  return feats


class _QuantGram(torch.autograd.Function):
  """F F^T of (b, c, n) `flat` with F and the cotangent rounded by
  `quant`, accumulating in float32."""

  @staticmethod
  def forward(ctx, flat, quant):
    fq = quant(flat)
    ctx.save_for_backward(fq)
    ctx.quant = quant
    return fq @ fq.transpose(1, 2)

  @staticmethod
  def backward(ctx, g):
    fq, = ctx.saved_tensors
    return ctx.quant(g + g.transpose(1, 2)) @ fq, None


def _gram(features: torch.Tensor, quant=None) -> torch.Tensor:
  flat = features.flatten(2)
  product = (flat @ flat.transpose(1, 2) if quant is None else
             _QuantGram.apply(flat, quant))
  return product / float(features.shape[2] * features.shape[3])


def losses(pred: torch.Tensor, y: torch.Tensor, vgg_weights,
           quant=None) -> Dict[str, torch.Tensor]:
  """l1, vgg and style of NCHW predictions against y."""
  with torch.no_grad():
    ref = vgg_features(vgg_weights, y, quant)
  img = vgg_features(vgg_weights, pred, quant)
  vgg = sum(w * (ref[n] - img[n]).abs().mean()
            for n, w in zip(LOSS_LAYERS, LAYER_WEIGHTS)) / 255.0
  style = 0.0
  for n, w in zip(LOSS_LAYERS, LAYER_WEIGHTS):
    with torch.no_grad():
      gram_ref = _gram(ref[n] / 255.0, quant)
    style = style + w * (gram_ref - _gram(img[n] / 255.0, quant)).square(
        ).mean()
  return {'l1': (pred - y).abs().mean(), 'vgg': vgg, 'style': style}


# ---- the step ----------------------------------------------------------------


class Adam:
  """Adam on a dict of leaves, as the paper writes it."""

  def __init__(self, params: Dict[str, torch.Tensor]):
    self.t = 0
    self.m = {k: torch.zeros_like(v) for k, v in params.items()}
    self.v = {k: torch.zeros_like(v) for k, v in params.items()}

  def update(self, params, grads, lr: float) -> None:
    self.t += 1
    b1, b2 = BETAS
    for k, g in grads.items():
      self.m[k].mul_(b1).add_(g, alpha=1 - b1)
      self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
      m_hat = self.m[k] / (1 - b1**self.t)
      v_hat = self.v[k] / (1 - b2**self.t)
      params[k].sub_(lr * m_hat / (v_hat.sqrt() + EPSILON))


def gradient(params: Dict[str, torch.Tensor], options: dict,
             batch: Dict[str, torch.Tensor], generator: torch.Generator,
             loss_weights: Dict[str, float], vgg_weights, quant=None,
             keep: Optional[int] = None
             ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
  """One step's losses (with 'total') and gradients at `params`, on NHWC
  f32 `batch` (on the params' device): augment, forward, weighted losses,
  backward. `keep` trains on the batch's first `keep` examples alone (a
  fault for the controls)."""
  nchw = {k: batch[k].permute(0, 3, 1, 2) for k in ('x0', 'x1', 'y')}
  nchw = augment(nchw, draw(generator, nchw['y'].shape[0]))
  if keep is not None:
    nchw = {k: v[:keep] for k, v in nchw.items()}
  leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
  pred = film_net.forward(leaves, options, nchw['x0'], nchw['x1'], quant)
  values = losses(pred, nchw['y'], vgg_weights, quant)
  total = sum(loss_weights[k] * values[k] for k in values)
  grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
  out = {k: float(v.detach()) for k, v in values.items()}
  out['total'] = float(total.detach())
  return out, grads


def step(params: Dict[str, torch.Tensor], options: dict, adam: Adam,
         batch: Dict[str, torch.Tensor], generator: torch.Generator,
         loss_weights: Dict[str, float], lr: float, vgg_weights,
         quant=None, keep: Optional[int] = None
         ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
  """`gradient`, then Adam: the losses and the gradients."""
  out, grads = gradient(params, options, batch, generator, loss_weights,
                        vgg_weights, quant, keep)
  with torch.no_grad():
    adam.update(params, grads, lr)
  return out, grads


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              rule: Optional[Dict[str, float]] = None) -> Dict[str, float]:
  """Each leaf's gap between two leaf norms, against the larger of the
  reference leaf's norm and the median leaf's; leaves whose norm in
  `rule` (the reference's first gradient) is under a thousandth of the
  median leaf's are left out."""
  rule = reference if rule is None else rule
  floor = sorted(rule.values())[len(rule) // 2]
  median = sorted(reference.values())[len(reference) // 2]
  return {k: abs(program[k] - ref) / max(ref, median)
          for k, ref in reference.items() if rule[k] >= 1e-3 * floor}


def diff_norms(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor],
               keep) -> Dict[str, float]:
  """Each kept leaf's norm of the difference over the reference's norm."""
  return {k: float((program[k].double() - reference[k].double()).norm() /
                   reference[k].double().norm().clamp_min(1e-30))
          for k in keep}


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             rule: Optional[Dict[str, float]] = None) -> Tuple[float, str]:
  """The worst leaf's gap (`leaf_gaps`) and its name."""
  gaps = leaf_gaps(program, reference, rule)
  name = max(gaps, key=gaps.get)
  return gaps[name], name


def run(params: Dict[str, torch.Tensor], options: dict,
        batches: List[Dict[str, torch.Tensor]], generators, loss_weights,
        lr: float, vgg_weights, quant=None, keep: Optional[int] = None,
        keep_from: int = 0, states: bool = False) -> dict:
  """The first len(batches) steps from `params` (updated in place):
  each step's losses and gradient leaf norms, the first gradient, and the
  leaf norms of the parameters' change. `keep` applies from step
  `keep_from` on. With `states`, also the parameters before each step
  after the first (on the host), which `follow` starts from."""
  start = {k: v.clone() for k, v in params.items()}
  adam = Adam(params)
  step_losses, step_grads, before = [], [], []
  for i, (batch, generator) in enumerate(zip(batches, generators)):
    if states and i:
      before.append({k: v.to('cpu', copy=True) for k, v in params.items()})
    values, grads = step(params, options, adam, batch, generator,
                         loss_weights[i], lr, vgg_weights, quant,
                         keep if i >= keep_from else None)
    step_losses.append(values)
    step_grads.append(leaf_norms(grads))
    if i == 0:
      first_grads = {k: v.cpu() for k, v in grads.items()}
    del grads
  change = leaf_norms({k: params[k] - start[k] for k in params})
  return {'losses': step_losses, 'grad_norms': step_grads[0],
          'step_grad_norms': step_grads, 'change_norms': change,
          'grads': first_grads, 'states': before,
          'params': {k: v.cpu() for k, v in params.items()}}


def follow(states: List[Dict[str, torch.Tensor]], options: dict,
           batches: List[Dict[str, torch.Tensor]], generators, loss_weights,
           vgg_weights, device) -> List[dict]:
  """Steps 1.. each from the parameters another run held before it
  (`states[i - 1]` before step i): its losses and gradient leaf norms."""
  out = []
  for i, held in enumerate(states, start=1):
    params = {k: v.to(device) for k, v in held.items()}
    values, grads = gradient(params, options, batches[i], generators[i],
                             loss_weights[i], vgg_weights)
    out.append({'losses': values, 'grad_norms': leaf_norms(grads)})
    del params, grads
  return out
