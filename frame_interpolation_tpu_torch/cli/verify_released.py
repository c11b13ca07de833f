r"""Released-checkpoint parity gate (PyTorch port): one command, one JSON line.

The port of frame_interpolation_tpu/cli/verify_released.py. Given a
release artifact of the reference (its L1/VGG/Style models,
google-research/frame-interpolation README.md:228-236), it checks that the
port reproduces it:

  1. **import**: the TF SavedModel or checkpoint maps onto the model
     (io/tf_import.py, no TensorFlow needed) with every weight consumed and
     shape-checked;
  2. **forward smoke and agreement**: the mid-frame of a photo pair is
     finite, of the input's shape and the same twice, and agrees with the
     SavedModel's own TF forward at >= --min_agreement_db PSNR (default
     50);
  3. **benchmark delta**: the mean PSNR over an eval TFRecord (e.g. the
     one cli/create_middlebury_tfrecord.py builds) differs from the TF
     SavedModel's mean by < --max_benchmark_delta_db (default 0.05).

The agreement and the benchmark delta need TensorFlow importable and a
SavedModel (not a bare checkpoint); without either they report "skipped"
and the gate passes on the checks that ran (the output says which). So on
a host with TensorFlow on the CPU all three run; on a GPU host without it
the import and the smoke run on the card:

  python3 -m frame_interpolation_tpu_torch.cli.verify_released \
    --model_path /path/to/saved_model \
    --frame1 photos/one.png --frame2 photos/two.png \
    --tfrecord middlebury.tfrecord@3 [--device cpu]

Exit status 0 iff every check that ran passes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np

_ALIGN = 64


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--model_path', required=True,
                      help='Released TF SavedModel dir (or TF checkpoint '
                      'dir, or a bundle: those support the import and '
                      'smoke checks only).')
  parser.add_argument('--frame1', default=None,
                      help='First photo of the agreement-check pair.')
  parser.add_argument('--frame2', default=None,
                      help='Second photo of the agreement-check pair.')
  parser.add_argument('--tfrecord', default=None,
                      help="Eval TFRecord spec ('file' or 'file@N') for the "
                      'benchmark-delta check.')
  parser.add_argument('--max_examples', type=int, default=-1,
                      help='Benchmark-delta example limit; -1 = all.')
  parser.add_argument('--min_agreement_db', type=float, default=50.0,
                      help='Forward-agreement PSNR bar (dB).')
  parser.add_argument('--max_benchmark_delta_db', type=float, default=0.05,
                      help='Benchmark mean-PSNR delta budget (dB).')
  parser.add_argument('--dtype_policy', default='float32',
                      choices=['float32', 'bfloat16'],
                      help="Forward precision ('float32' keeps the check "
                      "strict; 'bfloat16' verifies the serving policy "
                      'instead).')
  parser.add_argument('--device', default='cuda',
                      help="Torch device: 'cuda' (default) or 'cpu'.")
  return parser


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
  mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
  if mse == 0.0:
    return float('inf')
  return float(10.0 * np.log10(1.0 / mse))


def _pad_to_align(x: np.ndarray, align: int):
  """Zero-pads H and W up to multiples of `align`, centered (offset
  pad // 2, as tf.image.pad_to_bounding_box in the reference's
  eval/interpolator.py:30-63); returns (padded, (top, left))."""
  height, width = x.shape[1:3]
  pad_h, pad_w = -height % align, -width % align
  top, left = pad_h // 2, pad_w // 2
  padded = np.pad(x, ((0, 0), (top, pad_h - top), (left, pad_w - left),
                      (0, 0)))
  return padded, (top, left)


def _tf_forward_fn(model_path: str):
  """The released SavedModel's own forward (pad -> call -> crop), or None
  without TensorFlow or without a SavedModel.

  Reproduces how the reference drives it (eval/interpolator.py:172-206):
  align-pad both frames, call the model with {'x0','x1','time'}, crop the
  'image' output back.
  """
  from ..io import params_io
  if not params_io.is_tf_saved_model(model_path):
    return None
  try:
    import tensorflow as tf  # lazy: the only TensorFlow in the port
  except ImportError:
    return None

  model = tf.saved_model.load(model_path)

  def forward(x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    height, width = x0.shape[1:3]
    x0p, (top, left) = _pad_to_align(np.asarray(x0, np.float32), _ALIGN)
    x1p, _ = _pad_to_align(np.asarray(x1, np.float32), _ALIGN)
    inputs = {
        'x0': tf.constant(x0p, tf.float32),
        'x1': tf.constant(x1p, tf.float32),
        'time': tf.constant(np.full((x0.shape[0], 1), 0.5, np.float32)),
    }
    try:
      # How the reference drives Keras SavedModels (eval/interpolator.py:198).
      out = model(inputs, training=False)
    except (TypeError, AttributeError, ValueError):
      out = model.signatures['serving_default'](**inputs)
    image = out['image'].numpy()
    return image[:, top:top + height, left:left + width, :]

  return forward


def run_gate(model_path: str,
             frame1: Optional[str] = None,
             frame2: Optional[str] = None,
             tfrecord_spec: Optional[str] = None,
             max_examples: int = -1,
             min_agreement_db: float = 50.0,
             max_benchmark_delta_db: float = 0.05,
             dtype_policy: str = 'float32',
             options=None,
             device: Any = 'cuda') -> Dict:
  """Runs every available check; returns the result dict (see module doc).

  `options` overrides the model config (default: auto — released config for
  TF artifacts, the stored config for bundles); tests use it to gate
  against small oracle models.
  """
  checks: Dict[str, Dict] = {}

  # 1. Import: the loader shape-checks and consumes every variable.
  try:
    from ..inference import Interpolator, load_interpolator
    if options is not None:
      from ..io import tf_import
      state, opts = tf_import.load_tf_params(model_path, options)
      opts = dataclasses.replace(opts, dtype_policy=dtype_policy)
      interp = Interpolator(state, opts, align=_ALIGN, device=device)
    else:
      interp = load_interpolator(model_path, align=_ALIGN,
                                 dtype_policy=dtype_policy, device=device)
    checks['import'] = {'pass': True}
  except Exception as e:  # the gate reports any failure to load as a check
    checks['import'] = {'pass': False,
                        'error': f'{type(e).__name__}: {e}'}
    return {'pass': False, 'checks': checks}

  tf_forward = _tf_forward_fn(model_path)
  skip_reason = ('tensorflow or SavedModel signature unavailable'
                 if tf_forward is None else None)

  # 2. Forward smoke + agreement on a photo pair. The smoke half always
  # runs when frames are given (also where the TF forward is unavailable):
  # the imported weights must produce a finite, correctly-shaped,
  # deterministic mid-frame.
  if frame1 and frame2:
    from ..io import images
    x0 = images.read_image(frame1)[None]
    x1 = images.read_image(frame2)[None]
    dt = np.full((1,), 0.5, np.float32)
    ours = interp.interpolate(x0, x1, dt)
    ours2 = interp.interpolate(x0, x1, dt)
    finite = bool(np.isfinite(ours).all())
    shape_ok = ours.shape == x0.shape
    deterministic = bool(np.array_equal(ours, ours2))
    checks['forward_smoke'] = {
        'finite': finite, 'shape_ok': shape_ok,
        'deterministic': deterministic,
        'pass': finite and shape_ok and deterministic}
    if tf_forward is None:
      checks['forward_agreement'] = {'skipped': skip_reason}
    else:
      theirs = tf_forward(x0, x1)
      db = _psnr(np.clip(ours, 0.0, 1.0), np.clip(theirs, 0.0, 1.0))
      checks['forward_agreement'] = {
          'psnr_db': round(db, 2), 'min_db': min_agreement_db,
          'pass': bool(db >= min_agreement_db)}
  else:
    checks['forward_smoke'] = {'skipped': 'no --frame1/--frame2'}
    checks['forward_agreement'] = {'skipped': 'no --frame1/--frame2'}

  # 3. Benchmark mean-PSNR delta over an eval TFRecord.
  if tfrecord_spec:
    if tf_forward is None:
      checks['benchmark_delta'] = {'skipped': skip_reason}
    else:
      from ..data import dataset as dataset_lib
      ours_psnr, tf_psnr = [], []
      for example in dataset_lib.eval_dataset(
          tfrecord_spec, batch_size=1, max_examples=max_examples,
          with_path=False):
        x0, x1, y = example['x0'], example['x1'], example['y']
        ours = interp.interpolate(x0, x1, example['time'][:, 0])
        theirs = tf_forward(x0, x1)
        ours_psnr.append(_psnr(np.clip(ours, 0.0, 1.0), y))
        tf_psnr.append(_psnr(np.clip(theirs, 0.0, 1.0), y))
      delta = abs(float(np.mean(ours_psnr)) - float(np.mean(tf_psnr)))
      checks['benchmark_delta'] = {
          'ours_mean_psnr_db': round(float(np.mean(ours_psnr)), 4),
          'tf_mean_psnr_db': round(float(np.mean(tf_psnr)), 4),
          'delta_db': round(delta, 4),
          'max_delta_db': max_benchmark_delta_db,
          'num_examples': len(ours_psnr),
          'pass': bool(delta < max_benchmark_delta_db)}
  else:
    checks['benchmark_delta'] = {'skipped': 'no --tfrecord'}

  ran = [c for c in checks.values() if 'pass' in c]
  return {'pass': all(c['pass'] for c in ran),
          'checks_run': len(ran), 'checks': checks}


def main(argv: Optional[Sequence[str]] = None) -> int:
  """Prints the result line; returns the exit status."""
  args = _parser().parse_args(argv)
  from ._common import device_from_flag
  result = run_gate(
      args.model_path, args.frame1, args.frame2, args.tfrecord,
      args.max_examples, args.min_agreement_db, args.max_benchmark_delta_db,
      args.dtype_policy, device=device_from_flag(args.device))
  print(json.dumps(result))
  return 0 if result['pass'] else 1


if __name__ == '__main__':
  sys.exit(main())
