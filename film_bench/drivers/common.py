"""What the drivers share: the port's model from the configuration, its
weights from the seed, frames for the reference."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import weights
from ..costs import film_net as costs
from ..reference import film_net as ref


def options_dict(config: dict) -> dict:
  """The model block of a configuration: Options' fields."""
  model = dict(config['model'])
  for key in ('flow_convs', 'flow_filters'):
    model[key] = tuple(model[key])
  return model


def model(ctx):
  """The port's FilmNet at the configuration's options, on the card, with
  the seed's weights."""
  from frame_interpolation_tpu_torch.models.film_net import FilmNet
  from frame_interpolation_tpu_torch.options import Options
  options = Options(**options_dict(ctx.config))
  params = weights.film_net(ref.parameter_shapes(dataclasses.asdict(options)),
                            ctx.seed, ctx.device)
  with torch.device(ctx.device):
    net = FilmNet(options)
  net.load_state_dict(params)
  return net, options


def interpolator(ctx):
  """The port's Interpolator, as the CLIs build it: the configuration's
  precision policy and alignment, graphs on the card (the default)."""
  from frame_interpolation_tpu_torch.inference import Interpolator
  net, options = model(ctx)
  return Interpolator(net, options, align=int(ctx.config.get('align', 64)),
                      device=ctx.device)


def unit_nchw(frames: np.ndarray, device) -> torch.Tensor:
  """uint8 (N, H, W, 3) -> float32 (N, 3, H, W) in [0, 1] on `device`,
  each byte as numpy's correctly rounded v / 255."""
  unit = frames.astype(np.float32) / np.float32(255)
  return torch.from_numpy(unit).to(device).permute(0, 3, 1, 2)


def padded(size: int, align: int) -> int:
  return -(-size // align) * align


def pair_flops(options: dict, traffic: dict, align: int) -> float:
  return costs.pair_flops(options, 1, padded(int(traffic['height']), align),
                          padded(int(traffic['width']), align))


def sync(device) -> None:
  """Waits for the device's queued work (a card's; the CPU has none)."""
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)

