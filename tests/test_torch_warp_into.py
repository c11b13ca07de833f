"""csrc/warp.cu's slice mode (fi_warp_into_*) and the in-place fusion input,
on the card.

Every test here is marked `card` and skips where no CUDA device is
visible, as on the CPU suite. On a machine with the card and without JAX:

  python -m pytest --noconftest -p no:cacheprovider -m card \
      tests/test_torch_warp_into.py

(`--noconftest`: tests/conftest.py imports JAX and hides the card.)
The slice mode stores each pixel's C values at p * pitch + k of a wider
buffer; held here bit for bit against fi_warp_* into a contiguous tensor,
with every channel outside the slice keeping its sentinel, on both routes:
the vector route (C and pitch multiples of 8 bf16 or 4 f32, the slice on
a 16-byte boundary) and the run route (C = 1 and 3, the images, at even
and odd offsets; a vector-sized C at an offset off the 16-byte grid;
C = 67). The run route's warp and planes at C = 1 and 3 are held against
their plain versions too. Then the released model's in-place forward
against its concat path on the card: its warps bit for bit where both
routes run the 3x3 convs on the library ops, its image within 1% RMS
with the kernel too.
"""
import pytest
import torch

from frame_interpolation_tpu_torch.models import film_net
from frame_interpolation_tpu_torch.ops import _kernels, conv3x3_pieces, warp
from frame_interpolation_tpu_torch.options import Options

SENTINEL = -7.0  # exact in bf16, outside the warp's range of [0, 1)


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the card; see the docstring)')
  _kernels.library()
  return torch.device('cuda')


def _flow(b, h, w, device, seed):
  # Smooth flow of up to +-24 px plus a seam, so taps clamp at the edges
  # and neighbouring pixels read far apart.
  g = torch.Generator().manual_seed(seed)
  yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32),
                          indexing='ij')
  flow = torch.stack([24 * torch.sin(yy / 17.0) * torch.cos(xx / 23.0),
                      24 * torch.cos(yy / 19.0) * torch.sin(xx / 29.0)], -1)
  flow[:, :w // 2] += 9.5
  flow = flow + torch.rand(b, h, w, 2, generator=g)
  return flow.to(device).contiguous()


# (dtype, C, pitch, offset, the route it takes).
CASES = [
    (torch.bfloat16, 64, 144, 0, 'vector'),
    (torch.bfloat16, 64, 144, 64, 'vector'),     # 128 bytes in
    (torch.bfloat16, 192, 400, 192, 'vector'),
    (torch.bfloat16, 960, 1936, 960, 'vector'),
    (torch.bfloat16, 3, 144, 128, 'run'),      # image 0, even offset
    (torch.bfloat16, 3, 144, 131, 'run'),      # image 1, odd offset
    (torch.bfloat16, 1, 8, 5, 'run'),
    (torch.bfloat16, 64, 144, 3, 'run'),         # off the 16-byte grid
    (torch.bfloat16, 67, 144, 1, 'run'),
    (torch.float32, 64, 144, 64, 'vector'),      # 256 bytes in
    (torch.float32, 3, 144, 131, 'run'),
    (torch.float32, 64, 138, 2, 'run'),          # pitch off the vector
]
# Each case at a small odd size, and the fusion's level-0 slices at 1080p.
SIZES = [(case, (2, 37, 53)) for case in CASES] + [
    (case, (1, 1088, 1920)) for case in CASES
    if case[0] == torch.bfloat16 and case[1:3] in ((64, 144), (3, 144))]


@pytest.mark.card
@pytest.mark.parametrize('case,size', SIZES)
def test_warp_into_writes_the_slice_as_the_contiguous_warp(card, case, size):
  dtype, c, pitch, offset, _ = case
  b, h, w = size
  g = torch.Generator().manual_seed(c * 1000 + offset)
  image = torch.rand(b, h, w, c, generator=g).to(card, dtype)
  flow = _flow(b, h, w, card, seed=offset)
  want = warp.backward_warp_kernel(image, flow)
  out = torch.full((b, h, w, pitch), SENTINEL, dtype=dtype, device=card)
  _kernels.reset_launch_counts()
  warp.backward_warp_into(image, flow, out, offset)
  torch.cuda.synchronize()
  assert _kernels.launch_counts()['warp_slice'] == 1
  assert torch.equal(out[..., offset:offset + c], want)
  outside = torch.cat([out[..., :offset], out[..., offset + c:]], -1)
  assert (outside == SENTINEL).all()


@pytest.mark.card
@pytest.mark.parametrize('dtype,bound', [(torch.bfloat16, 2 * 2.0**-8),
                                         (torch.float32, 1e-5)])
@pytest.mark.parametrize('c', [1, 3])
def test_narrow_channels_match_the_plain_warp_and_planes(card, dtype, bound,
                                                        c):
  # Max-abs bounds of the other routes' checks (chip_smoke.py): one
  # rounding of the f32 blend to bf16 either side, FMA contraction in f32.
  g = torch.Generator().manual_seed(c)
  image = torch.rand(2, 37, 53, c, generator=g).to(card, dtype)
  flow = _flow(2, 37, 53, card, seed=c)
  got = [warp.backward_warp_kernel(image, flow),
         *warp.warp_planes_kernel(image, flow)]
  want = [warp.backward_warp_plain(image, flow),
          *warp.warp_planes_plain(image, flow)]
  for name, a, b in zip(('warp', 'du', 'dv'), got, want):
    assert float((a.float() - b.float()).abs().max()) <= bound, name


@pytest.mark.card
def test_in_place_forward_matches_the_concat_path_on_the_card(card,
                                                               monkeypatch):
  # The released model under the bf16 policy at 256x448: the in-place
  # route (inference) against the concat route (a grad-recording forward)
  # on the same weights and frames. The inference route also runs the flow
  # estimators' and the decoder's 3x3 convs as one kernel each
  # (ops/conv3x3_pieces.py), whose f32 sums round otherwise than the
  # library ops of the grad-recording route: so the flows, and the warps
  # that read them, are the same bits only with those convs on the library
  # ops in both. Held first that way, then with the kernel.
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = film_net.init_params(film_net.create_model(options),
                               torch.Generator().manual_seed(0)).to(card)
  g = torch.Generator().manual_seed(1)
  x0, x1 = (torch.rand(1, 256, 448, 3, generator=g).to(card)
            for _ in range(2))
  t = torch.full((1, 1), 0.5, device=card)
  _kernels.reset_launch_counts()
  want = model(x0, x1, t)
  assert _kernels.launch_counts()['warp_slice'] == 0
  ref = want['image'].detach()

  def rel_rms(image):
    return float((image - ref).pow(2).mean().sqrt() /
                 ref.pow(2).mean().sqrt())

  with monkeypatch.context() as patch:
    patch.setattr(conv3x3_pieces, 'engages', lambda *args: False)
    with torch.inference_mode():
      got = model(x0, x1, t)
  torch.cuda.synchronize()
  assert _kernels.launch_counts()['warp_slice'] == 20
  assert _kernels.launch_counts()['conv3x3_pieces'] == 0
  for key in ('x0_warped', 'x1_warped'):
    assert torch.equal(got[key], want[key].detach()), key
  assert rel_rms(got['image']) <= 0.01, rel_rms(got['image'])
  with torch.inference_mode():
    got = model(x0, x1, t)
  torch.cuda.synchronize()
  assert _kernels.launch_counts()['warp_slice'] == 40
  assert _kernels.launch_counts()['conv3x3_pieces'] == 50
  assert rel_rms(got['image']) <= 0.01, rel_rms(got['image'])
