"""The TF release import and its parity gate in the PyTorch port, on the CPU.

The TF oracle (tests/tf_oracle.py, at tests/test_tf_import.py's config)
saved by TensorFlow as a SavedModel and as a tf.train.Checkpoint; the
port's io/tf_import reads both without TensorFlow and must give the
state_dict that JAX's importer gives (bit for bit), whose forward matches
JAX's and the oracle's; load_interpolator and build_params --tf_model
read both containers of the released config; the malformed inputs of
JAX's tests raise the same exception types in both implementations; and
the port's verify_released passes the oracle release with all its checks,
fails a perturbed one, and reports its skips. Three JAX compiles: the
template init of JAX's load_tf_params for each container and the forward.
"""
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip('tensorflow')

import chip_smoke  # noqa: E402  (the repo root is on sys.path under pytest)
from frame_interpolation_tpu.io import params_io as jax_params_io  # noqa
from frame_interpolation_tpu.io import tf_import as jax_tf_import  # noqa
from frame_interpolation_tpu.models import film_net as jax_film_net  # noqa
from frame_interpolation_tpu.options import Options as JaxOptions  # noqa
from frame_interpolation_tpu_torch.cli import (build_params,  # noqa: E402
                                               verify_released)
from frame_interpolation_tpu_torch.data import records, tfrecord  # noqa
from frame_interpolation_tpu_torch.inference import (  # noqa: E402
    load_interpolator)
from frame_interpolation_tpu_torch.io import (images, params_io,  # noqa
                                              tf_import)
from frame_interpolation_tpu_torch.models import film_net  # noqa: E402
from frame_interpolation_tpu_torch.options import Options  # noqa: E402
import tf_oracle  # noqa: E402  (tests dir is on sys.path under pytest)

torch.set_num_threads(2)

OPTS_KW = dict(pyramid_levels=4, fusion_pyramid_levels=3,
               specialized_levels=2, flow_convs=(2, 2, 2),
               flow_filters=(8, 16, 16), sub_levels=3, filters=4,
               use_aux_outputs=True)
OPTS, JAX_OPTS = Options(**OPTS_KW), JaxOptions(**OPTS_KW)
# tests/test_tf_import.py's shape-ambiguous config: fusion levels 1 and 2
# both have 8 filters, so their 3x3 kernels share shapes.
AMB_KW = dict(pyramid_levels=5, fusion_pyramid_levels=4,
              specialized_levels=1, flow_convs=(1, 1), flow_filters=(8, 8),
              sub_levels=2, filters=4)
H, W = 32, 48
FORWARD_PSNR_DB = 50.0  # the port's model tests' bar against JAX


def _psnr(a, b):
  mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope='module')
def oracle():
  return tf_oracle.OracleFilmNet(JAX_OPTS, seed=7)


@pytest.fixture(scope='module')
def release(oracle, tmp_path_factory):
  """The oracle as TF saves it: {'saved_model': dir, 'checkpoint': dir}."""
  root = tmp_path_factory.mktemp('oracle')
  saved_model = str(root / 'saved_model')
  tf_oracle.save_oracle_saved_model(oracle, JAX_OPTS, saved_model, H, W)
  tf_oracle.save_oracle_checkpoint(oracle, str(root / 'ckpt' / 'ckpt'))
  return {'saved_model': saved_model, 'checkpoint': str(root / 'ckpt')}


@pytest.fixture(scope='module')
def jax_states(release):
  """JAX's load_tf_params of each container, as the port's state_dict."""
  states = {}
  for form, path in release.items():
    params, _ = jax_tf_import.load_tf_params(path, JAX_OPTS)
    states[form] = params_io.from_flax_params(
        jax.tree_util.tree_map(np.asarray, params))
  return states


def _oracle_state(oracle, options):
  """The oracle's variables under the port's names (fusion convs by their
  auto-names' creation index), kernels OIHW."""
  levels = options.fusion_pyramid_levels
  fusion = [f'conv_{i}_{s}' for i in range(levels - 1)
            for s in range(3)] + ['output_conv']
  state = {}
  for variable in oracle.variables:
    scope, *modules, leaf = variable.name.split(':')[0].split('/')
    if scope == 'fusion':
      base = modules[0]
      modules = [fusion[0 if base == 'conv2d' else int(base.split('_')[1])]]
    value = variable.numpy()
    if leaf == 'kernel':
      value = value.transpose(3, 2, 0, 1)
    name = '.'.join([scope, *modules, 'weight' if leaf == 'kernel' else
                     'bias'])
    state[name] = torch.from_numpy(np.ascontiguousarray(value))
  return state


def _assert_states_equal(got, want):
  assert set(got) == set(want)
  for name, value in want.items():
    assert got[name].dtype == value.dtype == torch.float32, name
    assert got[name].shape == value.shape, name
    assert got[name].numpy().tobytes() == value.numpy().tobytes(), name


# ---- the import against JAX's ------------------------------------------------


@pytest.mark.parametrize('form', ['saved_model', 'checkpoint'])
def test_load_tf_params_is_bit_equal_to_jax(form, oracle, release,
                                            jax_states):
  state, options = tf_import.load_tf_params(release[form], OPTS)
  assert options == OPTS
  _assert_states_equal(state, jax_states[form])
  _assert_states_equal(state, _oracle_state(oracle, OPTS))


def test_forward_matches_jax_and_the_oracle(oracle, release, jax_states):
  state, _ = tf_import.load_tf_params(release['saved_model'], OPTS)
  model = film_net.create_model(OPTS)
  model.load_state_dict(state)
  rng = np.random.RandomState(0)
  x0 = rng.rand(1, H, W, 3).astype(np.float32)
  x1 = rng.rand(1, H, W, 3).astype(np.float32)
  t = np.full((1, 1), 0.5, np.float32)
  with torch.inference_mode():
    got = model(torch.from_numpy(x0), torch.from_numpy(x1),
                torch.from_numpy(t))
  want = jax.jit(jax_film_net.create_model(JAX_OPTS).apply)(
      {'params': params_io.to_flax_params(jax_states['saved_model'])},
      x0, x1, t)
  theirs = oracle({'x0': x0, 'x1': x1, 'time': t})
  for key in ('image', 'x0_warped', 'x1_warped'):
    assert _psnr(got[key].numpy(), want[key]) >= FORWARD_PSNR_DB, key
    assert _psnr(got[key].numpy(), theirs[key].numpy()) >= FORWARD_PSNR_DB


# ---- the released config through the entry points ----------------------------


@pytest.fixture(scope='module')
def released(tmp_path_factory):
  """The oracle at the released config (34,436,667 parameters), saved by
  TF in both containers, and its weights under the port's names."""
  options = Options.film_net_released()
  model = tf_oracle.OracleFilmNet(JaxOptions.film_net_released(), seed=1)
  root = tmp_path_factory.mktemp('released')
  tf_oracle.save_oracle_saved_model(model, JaxOptions.film_net_released(),
                                    str(root / 'saved_model'), 64, 64)
  tf_oracle.save_oracle_checkpoint(model, str(root / 'ckpt' / 'ckpt'))
  return {'saved_model': str(root / 'saved_model'),
          'checkpoint': str(root / 'ckpt'),
          'state': _oracle_state(model, options)}


@pytest.mark.parametrize('form', ['saved_model', 'checkpoint'])
def test_load_interpolator_and_build_params_read_both_containers(
    form, released, tmp_path):
  path = released[form]
  interp = load_interpolator(path, align=64, dtype_policy='bfloat16',
                             device='cpu')
  assert interp.options == Options.film_net_released(dtype_policy='bfloat16')
  _assert_states_equal(interp.model.state_dict(), released['state'])
  if form == 'checkpoint':  # a checkpoint prefix loads as its directory
    prefix = tf.train.latest_checkpoint(path)
    _assert_states_equal(tf_import.load_tf_params(prefix)[0],
                         released['state'])
  with pytest.raises(SystemExit):  # --output is required with --tf_model
    build_params.main(['--tf_model', path])
  output = build_params.main(['--tf_model', path, '--output',
                              str(tmp_path / 'bundle')])
  state, options = params_io.load_state_bundle(output)
  assert options == Options.film_net_released()
  _assert_states_equal(state, released['state'])


# ---- malformed inputs, both implementations ----------------------------------


IMPLS = {
    'jax': types.SimpleNamespace(tf_import=jax_tf_import,
                                 options=JaxOptions,
                                 load=jax_params_io.load_params),
    'port': types.SimpleNamespace(
        tf_import=tf_import, options=Options,
        load=lambda path: load_interpolator(path, device='cpu')),
}


def _fusion_vars(impl, name_fn):
  """(named_vars, want) with distinct random kernels per fusion conv of
  the shape-ambiguous config."""
  options = impl.options(**AMB_KW)
  rng = np.random.RandomState(42)
  shapes = impl.tf_import._expected_fusion_shapes(options)
  assert len(shapes) != len(set(shapes)), 'config must be shape-ambiguous'
  modules = [f'conv_{i}_{s}' for i in range(options.fusion_pyramid_levels - 1)
             for s in range(3)] + ['output_conv']
  named, want = [], {}
  for k, (shape, module) in enumerate(zip(shapes, modules)):
    kernel = rng.rand(*shape).astype(np.float32)
    bias = rng.rand(shape[-1]).astype(np.float32)
    named.append((f'fusion/{name_fn(k, module)}/kernel', kernel))
    named.append((f'fusion/{name_fn(k, module)}/bias', bias))
    want[module] = kernel
  return named, want, options


def _assert_fusion(params, want):
  for module, kernel in want.items():
    np.testing.assert_array_equal(
        np.asarray(params['fusion'][module]['kernel']), kernel,
        err_msg=module)


def _level_slot(_, module):
  if module == 'output_conv':
    return 'output_conv'
  _, i, s = module.split('_')
  return f'level_{i}_slot_{s}'


def _case_config_mismatch_saved_model(impl, release, tmp_path):
  # The loaders assume the released config for a TF release.
  impl.load(release['saved_model'])


def _case_config_mismatch_checkpoint(impl, release, tmp_path):
  impl.load(release['checkpoint'])


def _case_missing_path(impl, release, tmp_path):
  impl.load(str(tmp_path / 'nope'))


def _case_no_checkpoint_state(impl, release, tmp_path):
  # An index file but no `checkpoint` state file naming a prefix.
  path = tmp_path / 'stateless'
  path.mkdir()
  (path / 'ckpt-1.index').write_bytes(b'')
  impl.tf_import.load_tf_params(str(path), impl.options(**OPTS_KW))


def _checkpoint_with_root(tmp_path, **objects):
  tf.train.Checkpoint(**objects).save(str(tmp_path / 'ckpt'))
  return str(tmp_path)


def _case_other_model_root(impl, release, tmp_path):
  # tf.train.Checkpoint(net=model): the root is found by its layout.
  oracle = tf_oracle.OracleFilmNet(JAX_OPTS, seed=7)
  path = _checkpoint_with_root(tmp_path, net=oracle)
  options = impl.options(**OPTS_KW)
  ours = impl.tf_import._import_named_variables(
      impl.tf_import._named_vars_from_checkpoint(path, options), options)
  base = impl.tf_import._import_named_variables(
      impl.tf_import._named_vars_from_checkpoint(release['checkpoint'],
                                                 options), options)
  for (p, a), (q, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                            jax.tree_util.tree_leaves_with_path(base)):
    assert p == q
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _case_no_model_root(impl, release, tmp_path):
  module = tf.Module()
  module.kernel = tf.Variable(np.zeros((3, 3, 2, 2), np.float32))
  path = _checkpoint_with_root(tmp_path, net=module)
  impl.tf_import._named_vars_from_checkpoint(path, impl.options(**OPTS_KW))


def _case_permuted_auto_names(impl, release, tmp_path):
  # Keras auto-names in creation order: conv2d, conv2d_1, ...; a container
  # may list them in any order (conv2d_10 before conv2d_2).
  named, want, options = _fusion_vars(
      impl, lambda k, _: 'conv2d' if k == 0 else f'conv2d_{k}')
  for permuted in (named, list(reversed(named)),
                   sorted(named, key=lambda kv: kv[0])):
    _assert_fusion(impl.tf_import._import_named_variables(permuted, options),
                   want)


def _case_shared_shapes_without_creation_order(impl, release, tmp_path):
  named, _, options = _fusion_vars(impl, lambda k, _: f'op{k}x')
  impl.tf_import._import_named_variables(named, options)


def _case_level_slot_scopes(impl, release, tmp_path):
  named, want, options = _fusion_vars(impl, _level_slot)
  for variables in (named, list(reversed(named))):
    _assert_fusion(impl.tf_import._import_named_variables(variables,
                                                          options), want)


def _case_level_slot_wrong_shapes(impl, release, tmp_path):
  # A level_0 scope carrying a level_1 shape.
  named, _, options = _fusion_vars(impl, _level_slot)
  swapped = [(name.replace('level_0_slot_1', 'level_1_slot_1')
              if 'level_0_slot_1' in name else
              name.replace('level_1_slot_1', 'level_0_slot_1'), value)
             for name, value in named]
  impl.tf_import._import_named_variables(swapped, options)


def _case_fusion_count_mismatch(impl, release, tmp_path):
  named, _, options = _fusion_vars(impl, _level_slot)
  impl.tf_import._import_named_variables(
      [(n, v) for n, v in named if 'output_conv' not in n], options)


def _case_prefixed_names(impl, release, tmp_path):
  # Exports that wrap variables in an extra scope ('film_net/...'): the
  # importer anchors on the first known scope component.
  options = impl.options(**OPTS_KW)
  named = impl.tf_import._named_vars_from_saved_model(release['saved_model'])
  prefixed = [('film_net/' + name, value) for name, value in named]
  params = impl.tf_import._import_named_variables(prefixed, options)
  baseline = impl.tf_import._import_named_variables(named, options)
  for a, b in zip(jax.tree_util.tree_leaves(params),
                  jax.tree_util.tree_leaves(baseline)):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _case_unknown_scope(impl, release, tmp_path):
  impl.tf_import._import_named_variables(
      [('mystery/conv/kernel', np.zeros((3, 3, 2, 2), np.float32))],
      impl.options(**OPTS_KW))


# (case, the exception type both implementations raise or None, match).
CASES = [
    ('config_mismatch_saved_model', ValueError, 'fusion convs'),
    ('config_mismatch_checkpoint', KeyError, 'not found'),
    ('missing_path', FileNotFoundError, None),
    ('no_checkpoint_state', FileNotFoundError, 'No checkpoint found'),
    ('other_model_root', None, None),
    ('no_model_root', ValueError, 'model root'),
    ('permuted_auto_names', None, None),
    ('shared_shapes_without_creation_order', ValueError, 'creation order'),
    ('level_slot_scopes', None, None),
    ('level_slot_wrong_shapes', ValueError, 'shape'),
    ('fusion_count_mismatch', ValueError, 'found 9 fusion convs'),
    ('prefixed_names', None, None),
    ('unknown_scope', ValueError, 'unexpected variable'),
]


@pytest.mark.parametrize('impl', ['jax', 'port'])
@pytest.mark.parametrize('case,error,match', CASES,
                         ids=[case for case, _, _ in CASES])
def test_malformed_input_raises_as_jax_does(case, error, match, impl,
                                            release, tmp_path):
  run = globals()[f'_case_{case}']
  if error is None:
    run(IMPLS[impl], release, tmp_path)
    return
  with pytest.raises(error, match=match) as info:
    run(IMPLS[impl], release, tmp_path)
  assert type(info.value) is error


def test_saved_model_attribute_without_a_name_raises(tmp_path):
  os.makedirs(tmp_path / 'variables')
  (tmp_path / 'saved_model.pb').write_bytes(b'')
  chip_smoke.write_tf_bundle(
      str(tmp_path / 'variables' / 'variables'),
      [('feat/kernel' + chip_smoke.TF_ATTRIBUTE, '',
        np.zeros((1, 1, 1, 1), np.float32))])
  with pytest.raises(ValueError, match='no full_name'):
    tf_import.load_tf_params(str(tmp_path), OPTS)


# ---- the release gate ----------------------------------------------------------


@pytest.fixture(scope='module')
def gate_inputs(tmp_path_factory):
  """Two seeded frames and a 3-example eval TFRecord."""
  root = tmp_path_factory.mktemp('gate')
  rng = np.random.RandomState(0)
  frames = []
  for name in ('one.png', 'two.png'):
    frames.append(str(root / name))
    images.write_image(frames[-1], rng.rand(H, W, 3).astype(np.float32))
  rec = str(root / 'eval.tfrecord')
  with tfrecord.TFRecordWriter(tfrecord.shard_filename(rec, 0, 1)) as w:
    for i in range(3):
      triplet = [rng.randint(0, 256, (H, W, 3), np.uint8) for _ in range(3)]
      w.write(records.make_triplet_example(triplet, path=f'ex_{i}.png'))
  return {'frame1': frames[0], 'frame2': frames[1], 'tfrecord': f'{rec}@1'}


def test_gate_passes_the_oracle_release(release, gate_inputs):
  result = verify_released.run_gate(
      release['saved_model'], gate_inputs['frame1'], gate_inputs['frame2'],
      gate_inputs['tfrecord'], options=OPTS, device='cpu')
  assert result['pass'], json.dumps(result)
  assert result['checks_run'] == 4  # nothing skipped: TF is available
  assert result['checks']['forward_smoke']['pass']
  assert result['checks']['forward_agreement']['psnr_db'] >= 50.0
  delta = result['checks']['benchmark_delta']
  assert delta['num_examples'] == 3 and delta['delta_db'] < 0.05


def test_gate_fails_a_perturbed_release(release, gate_inputs, tmp_path,
                                        monkeypatch):
  # The oracle's weights with one bias moved by 0.01, written as a
  # SavedModel's variables, gated against the original's TF forward.
  state, _ = tf_import.load_tf_params(release['saved_model'], OPTS)
  state['fusion.output_conv.bias'] += 0.01
  perturbed = str(tmp_path / 'perturbed')
  chip_smoke.write_tf_checkpoint(perturbed, state, OPTS, 'saved_model')
  original = verify_released._tf_forward_fn(release['saved_model'])
  monkeypatch.setattr(verify_released, '_tf_forward_fn',
                      lambda _: original)
  result = verify_released.run_gate(
      perturbed, gate_inputs['frame1'], gate_inputs['frame2'], options=OPTS,
      device='cpu')
  assert result['checks']['import']['pass']
  assert result['checks']['forward_smoke']['pass']
  agreement = result['checks']['forward_agreement']
  assert not agreement['pass'] and agreement['psnr_db'] < 50.0
  assert not result['pass']


def test_gate_import_only_reports_skips(release):
  result = verify_released.run_gate(release['saved_model'], options=OPTS,
                                    device='cpu')
  assert result['pass'] and result['checks_run'] == 1
  for check in ('forward_smoke', 'forward_agreement', 'benchmark_delta'):
    assert 'skipped' in result['checks'][check]


def test_gate_reports_an_import_failure(tmp_path):
  result = verify_released.run_gate(str(tmp_path / 'nope'), device='cpu')
  assert not result['pass']
  assert not result['checks']['import']['pass']
  assert result['checks']['import']['error'].startswith('FileNotFoundError')


def test_cli_gates_a_released_checkpoint(released, gate_inputs, capsys):
  # A checkpoint has no TF forward: the import and the smoke run, the TF
  # checks skip, as on a host without TensorFlow.
  status = verify_released.main([
      '--model_path', released['checkpoint'], '--frame1',
      gate_inputs['frame1'], '--frame2', gate_inputs['frame2'],
      '--tfrecord', gate_inputs['tfrecord'], '--device', 'cpu'])
  result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert status == 0 and result['pass'] and result['checks_run'] == 2
  reason = 'tensorflow or SavedModel signature unavailable'
  assert result['checks']['forward_agreement'] == {'skipped': reason}
  assert result['checks']['benchmark_delta'] == {'skipped': reason}
