"""The port's K1 (`bayesnf_torch.ops.fused_mlp.fused_train`) against the JAX one.

On the CPU the wrapper computes `fused_train_reference`, the plain PyTorch
version, which must match both the JAX package's `fused_train` (Pallas
interpret mode, 32-row tiles, so n = 70 leaves a ragged tail) and its
autodiff oracle (`field.apply_field_t` + `likelihoods.log_likelihood`
through `jax.grad`), at the JAX package's own bounds
(`tests/test_fused_mlp.py`): losses rtol 2e-4, gradients rtol 2e-4 /
atol 2e-5. Stage 3's inputs are held to the same bounds: x, seasonal rows
and y per member (rep 1) and per group of 2 members (rep 2), each group with
rows of its own. The CUDA kernel is held against the plain version on the
card by `tests/test_torch_gpu.py` and `chip_smoke.py`.

The count models (NB, ZINB) are held to the JAX package's own count bounds
(`tests/test_fused_mlp.py`): against its Pallas kernel, whose Stirling
log-gamma differs from the exact one by up to ~3e-4 relative, losses rtol
1e-3 and gradients rtol 2e-3 / atol 2e-4; against its autodiff oracle (the
same exact math as the plain version) the NORMAL bounds above. The
observation scalars a likelihood does not read get exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnf_torch.models import field as t_field
from bayesnf_torch.ops import fused_mlp as t_fused
from bayesnf_tpu.models import field as j_field
from bayesnf_tpu.models import likelihoods as j_likelihoods
from bayesnf_tpu.ops import fused_mlp as j_fused

torch.set_num_threads(1)

TILE = 32
LIK_SCALE = 1.75
LOSS_RTOL = 2e-4
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
N_ROWS = 70  # Ragged in 32-row tiles.

CASES = {
    'depth2-seasonal-interactions': dict(
        depth=2, seasonal=True, interactions=((0, 1), (1, 2))),
    'depth1-seasonal': dict(depth=1, seasonal=True, interactions=()),
    'depth3-interactions': dict(depth=3, seasonal=False,
                                interactions=((0, 2),)),
    'depth2-no-seasonal-no-interactions': dict(
        depth=2, seasonal=False, interactions=()),
}


def _counts(shape, rng):
  """Count targets with a few zeros (the ZINB zero branch) and a heavy tail
  (log-gamma at larger arguments), as `tests/test_fused_mlp.py` draws
  them."""
  y = rng.poisson(rng.gamma(2.0, 4.0, size=shape)).astype(np.float32)
  y.reshape(-1)[::7] = 0.0
  return y


def _setup(depth, seasonal, interactions, members=3, seed=3):
  """(JAX config, numpy params, x_t (D, N), seasonal_t (2F, N), y (N,))."""
  config = j_field.FieldConfig.create(
      width=16, depth=depth, input_scales=[50.0, 1.0, 1.0],
      fourier_degrees=[3, 2, 0], interactions=list(interactions),
      seasonality_periods=[7.0] if seasonal else [],
      num_seasonal_harmonics=[2] if seasonal else [])
  rng = np.random.default_rng(seed)
  params = []
  for spec in j_field.param_specs(config):
    shape = (members,) + spec.shape
    draw = (np.clip(rng.normal(size=shape), -2, 2) if spec.is_matrix
            else 0.1 * rng.normal(size=shape))
    params.append(draw.astype(np.float32))
  x = (rng.normal(size=(N_ROWS, 3)) * 5).astype(np.float32)
  seasonal_t = np.asarray(
      j_field.seasonal_features_for(config, jnp.asarray(x))).T
  y = rng.normal(size=N_ROWS).astype(np.float32)
  return (config, params, np.ascontiguousarray(x.T),
          np.array(seasonal_t, dtype=np.float32, order='C'), y)


def _k1_args(config, params, x_t, seasonal_t, y, convert):
  """K1's arguments after `distribution`, without JAX's `tile`."""
  num_w = config.depth + 1
  return dict(
      depth=config.depth, lik_scale=LIK_SCALE,
      input_scales=config.input_scales,
      fourier_degrees=config.fourier_degrees,
      interactions=config.interactions,
      x_t=convert(x_t), seasonal_t=convert(seasonal_t),
      weights=tuple(convert(params[7 + 2 * l]) for l in range(num_w)),
      biases=tuple(convert(params[8 + 2 * l]) for l in range(num_w)),
      lsa=convert(params[j_field.IDX_LOG_SCALE_ADJ]),
      fs_raw=convert(params[j_field.IDX_FEATURE_SCALES]),
      scales_raw=convert(params[j_field.IDX_LAYER_SCALES]),
      logit=convert(params[j_field.IDX_ACTIVATION_LOGIT]),
      obs_raw=convert(np.stack(params[:3], axis=-1)),
      y=convert(y),
  )


def _torch_args(case):
  config, params, x_t, seasonal_t, y = _setup(**CASES[case])
  return config, params, _k1_args(config, params, x_t, seasonal_t, y,
                                   torch.as_tensor)


GROUPED_MEMBERS = 4
# Layouts of x / seasonal / y: row sets per input (None: one shared set).
LAYOUTS = {
    'grouped-rep2': (2, 2, 2),
    'per-member': (4, 4, 4),
    'x-grouped-y-shared': (2, 2, None),
    'x-shared-y-per-member': (None, None, 4),
}


def _grouped_args(layout, case='depth2-seasonal-interactions'):
  """(JAX config, params, numpy K1 inputs) with `LAYOUTS[layout]` row sets:
  every set has rows of its own (drawn with another seed)."""
  config, params, *_ = _setup(**CASES[case], members=GROUPED_MEMBERS)
  sets = [_setup(**CASES[case], members=1, seed=10 + i)[2:]
          for i in range(GROUPED_MEMBERS)]
  inputs = []
  for k, count in enumerate(LAYOUTS[layout]):
    inputs.append(sets[0][k] if count is None else
                  np.stack([sets[i][k] for i in range(count)]))
  return config, params, inputs


def _member_rows(a, shared_ndim, members=GROUPED_MEMBERS):
  """Member m's rows of a shared or grouped input (group m // rep)."""
  if a.ndim == shared_ndim:
    return [a] * members
  rep = members // a.shape[0]
  return [a[m // rep] for m in range(members)]


def _by_slot(config, outs):
  """K1's gradient outputs as {param slot: numpy array}."""
  _, dlsa, dfs, dws, dbs, dscales, dlogit, dobs = outs
  grads = j_field.scatter_fused_train_grads(
      config, *[np.asarray(a) for a in (dlsa, dfs)],
      [np.asarray(a) for a in dws], [np.asarray(a) for a in dbs],
      *[np.asarray(a) for a in (dscales, dlogit, dobs)])
  return dict(enumerate(grads))


@pytest.mark.parametrize('case', sorted(CASES))
def test_reference_matches_pallas_interpret(case):
  config, params, args = _torch_args(case)
  got = t_fused.fused_train_reference('NORMAL', **args)
  j_args = _k1_args(config, params, *[np.asarray(a) for a in (
      args['x_t'], args['seasonal_t'], args['y'])], jnp.asarray)
  want = j_fused.fused_train('NORMAL', j_args.pop('depth'), TILE,
                             **j_args)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             rtol=LOSS_RTOL)
  got_slots, want_slots = _by_slot(config, got), _by_slot(config, want)
  for slot, w in want_slots.items():
    np.testing.assert_allclose(got_slots[slot], w, **GRAD_TOL,
                               err_msg=f'slot {slot}')


@pytest.mark.parametrize('case', sorted(CASES))
def test_reference_matches_jax_autodiff(case):
  config, params, args = _torch_args(case)
  got = t_fused.fused_train_reference('NORMAL', **args)
  x_t, seasonal_t, y = (jnp.asarray(args[k].numpy())
                        for k in ('x_t', 'seasonal_t', 'y'))

  def member_loss(p):
    pred = j_field.apply_field_t(config, p, x_t, seasonal_t)
    return -LIK_SCALE * j_likelihoods.log_likelihood(
        j_likelihoods.LikelihoodDist.NORMAL, p, pred, y)

  j_params = tuple(jnp.asarray(p) for p in params)
  want_losses = jax.vmap(member_loss)(j_params)
  want_grads = jax.grad(lambda ps: jax.vmap(member_loss)(ps).sum())(j_params)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want_losses),
                             rtol=LOSS_RTOL)
  got_slots = _by_slot(config, got)
  for slot, w in enumerate(want_grads):
    if slot in (j_field.IDX_NB_SHAPE_RAW, j_field.IDX_ZINB_LOGIT):
      # NORMAL never reads them: exactly zero.
      np.testing.assert_array_equal(got_slots[slot], np.zeros_like(w))
      continue
    np.testing.assert_allclose(got_slots[slot], np.asarray(w), **GRAD_TOL,
                               err_msg=f'slot {slot}')


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_grouped_inputs_match_pallas_interpret(layout):
  config, params, inputs = _grouped_args(layout)
  got = t_fused.fused_train_reference(
      'NORMAL', **_k1_args(config, params, *inputs, torch.as_tensor))
  j_args = _k1_args(config, params, *inputs, jnp.asarray)
  want = j_fused.fused_train('NORMAL', j_args.pop('depth'), TILE, **j_args)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             rtol=LOSS_RTOL)
  got_slots, want_slots = _by_slot(config, got), _by_slot(config, want)
  for slot, w in want_slots.items():
    np.testing.assert_allclose(got_slots[slot], w, **GRAD_TOL,
                               err_msg=f'slot {slot}')


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_grouped_inputs_match_jax_autodiff(layout):
  config, params, (x_t, seasonal_t, y) = _grouped_args(layout)
  got = t_fused.fused_train_reference(
      'NORMAL', **_k1_args(config, params, x_t, seasonal_t, y,
                           torch.as_tensor))
  # Member m's own rows, stacked: the oracle vmaps over members.
  rows = [jnp.asarray(np.stack(_member_rows(a, nd)))
          for a, nd in ((x_t, 2), (seasonal_t, 2), (y, 1))]

  def member_loss(p, xm, sm, ym):
    pred = j_field.apply_field_t(config, p, xm, sm)
    return -LIK_SCALE * j_likelihoods.log_likelihood(
        j_likelihoods.LikelihoodDist.NORMAL, p, pred, ym)

  j_params = tuple(jnp.asarray(p) for p in params)
  want_losses = jax.vmap(member_loss)(j_params, *rows)
  want_grads = jax.grad(
      lambda ps: jax.vmap(member_loss)(ps, *rows).sum())(j_params)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want_losses),
                             rtol=LOSS_RTOL)
  got_slots = _by_slot(config, got)
  for slot, w in enumerate(want_grads):
    np.testing.assert_allclose(got_slots[slot], np.asarray(w), **GRAD_TOL,
                               err_msg=f'slot {slot}')


def test_grouped_inputs_equal_their_per_member_copies():
  # Reading group m // rep is the same as a per-member copy of each group.
  config, params, inputs = _grouped_args('grouped-rep2')
  copies = [np.stack(_member_rows(a, nd))
            for a, nd in zip(inputs, (2, 2, 1))]
  got = t_fused.fused_train_reference(
      'NORMAL', **_k1_args(config, params, *inputs, torch.as_tensor))
  want = t_fused.fused_train_reference(
      'NORMAL', **_k1_args(config, params, *copies, torch.as_tensor))
  for g, w in zip(_by_slot(config, got).values(),
                  _by_slot(config, want).values()):
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('key', ['x_t', 'seasonal_t', 'y'])
def test_group_count_must_divide_members(key):
  config, params, inputs = _grouped_args('grouped-rep2')
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  args[key] = torch.cat([args[key], args[key][:1]])  # 3 sets, 4 members
  with pytest.raises(ValueError, match='must divide the member count'):
    t_fused.fused_train('NORMAL', **args)
  with pytest.raises(ValueError, match='divides the member count'):
    t_fused.fused_train_reference('NORMAL', **args)


def test_depth0_gives_a_zero_logit_gradient():
  config = t_field.FieldConfig.create(
      width=4, depth=0, input_scales=[1.0], fourier_degrees=[2],
      interactions=[], seasonality_periods=[], num_seasonal_harmonics=[])
  rng = np.random.default_rng(0)
  f = config.encoded_dim
  outs = t_fused.fused_train_reference(
      'NORMAL', 0, 1.0, config.input_scales, config.fourier_degrees, (),
      torch.as_tensor(rng.normal(size=(1, 9)).astype(np.float32)),
      torch.zeros((0, 9)), (torch.ones((2, f, 1)),), (torch.zeros((2, 1)),),
      torch.zeros((2, 1)), torch.zeros((2, 2)), torch.zeros((2, 1)),
      torch.zeros((2,)), torch.zeros((2, 3)), torch.zeros((9,)))
  assert torch.equal(outs[6], torch.zeros(2))
  assert outs[3][0].shape == (2, f, 1)


def test_wrapper_on_cpu_is_the_plain_version():
  _, _, args = _torch_args('depth2-seasonal-interactions')
  before = t_fused.fused_train.launches
  got = t_fused.fused_train('NORMAL', **args)
  assert t_fused.fused_train.launches == before
  want = t_fused.fused_train_reference('NORMAL', **args)
  for g, w in zip(got, want):
    for a, b in zip(g if isinstance(g, tuple) else (g,),
                    w if isinstance(w, tuple) else (w,)):
      assert torch.equal(a, b)


def test_wrapper_refuses_other_devices():
  _, _, args = _torch_args('depth1-seasonal')
  args = {k: (tuple(t.to('meta') for t in v) if isinstance(v, tuple)
              and v and isinstance(v[0], torch.Tensor)
              else v.to('meta') if isinstance(v, torch.Tensor) else v)
          for k, v in args.items()}
  with pytest.raises(ValueError, match='CUDA or CPU'):
    t_fused.fused_train('NORMAL', **args)


@pytest.mark.parametrize('change', [
    dict(n_valid=N_ROWS + 1),
], ids=['n_valid'])
def test_unported_variants_raise(change):
  # Stage 4 is ported (tests/test_torch_parallel.py); a valid-row count
  # past the rows is refused by the wrapper and its plain version.
  _, _, args = _torch_args('depth1-seasonal')
  for fn in (t_fused.fused_train, t_fused.fused_train_reference):
    with pytest.raises(ValueError, match=r'n_valid must be in \[0, 70\]'):
      fn('NORMAL', **args, **change)


def test_unknown_precision_raises():
  _, _, args = _torch_args('depth1-seasonal')
  for fn in (t_fused.fused_train, t_fused.fused_train_reference):
    with pytest.raises(ValueError, match="'f32', 'bf16', 'highest'"):
      fn('NORMAL', **args, precision='fp16')


def test_unknown_likelihood_raises():
  _, _, args = _torch_args('depth1-seasonal')
  with pytest.raises(ValueError, match='unknown likelihood'):
    t_fused.fused_train('POISSON', **args)


COUNT_LOSS_RTOL = 1e-3
COUNT_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# Observation-scalar columns of dobs each likelihood does not read.
UNUSED_OBS = {'NB': (0, 2), 'ZINB': (0,)}
# (case, input layout or None for shared inputs)
COUNT_CASES = {
    'shared': ('depth2-seasonal-interactions', None),
    'shared-depth1': ('depth1-seasonal', None),
    'per-member': ('depth2-seasonal-interactions', 'per-member'),
    'grouped-rep2': ('depth2-seasonal-interactions', 'grouped-rep2'),
}


def _count_args(name):
  """(JAX config, params, numpy x_t, seasonal_t, count y) of a count case;
  y is shared or grouped as the layout's y."""
  case, layout = COUNT_CASES[name]
  if layout is None:
    config, params, x_t, seasonal_t, y = _setup(**CASES[case])
  else:
    config, params, (x_t, seasonal_t, y) = _grouped_args(layout, case)
  return config, params, x_t, seasonal_t, _counts(
      y.shape, np.random.default_rng(7))


def _assert_unused_obs_zero(distribution, got):
  dobs = got[-1].numpy()
  for col in UNUSED_OBS[distribution]:
    np.testing.assert_array_equal(dobs[:, col], 0.0)


@pytest.mark.parametrize('name', sorted(COUNT_CASES))
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_reference_matches_pallas_interpret(distribution, name):
  config, params, *inputs = _count_args(name)
  got = t_fused.fused_train_reference(
      distribution, **_k1_args(config, params, *inputs, torch.as_tensor))
  j_args = _k1_args(config, params, *inputs, jnp.asarray)
  want = j_fused.fused_train(distribution, j_args.pop('depth'), TILE,
                             **j_args)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             rtol=COUNT_LOSS_RTOL)
  _assert_unused_obs_zero(distribution, got)
  got_slots, want_slots = _by_slot(config, got), _by_slot(config, want)
  for slot, w in want_slots.items():
    np.testing.assert_allclose(got_slots[slot], w, **COUNT_GRAD_TOL,
                               err_msg=f'slot {slot}')


@pytest.mark.parametrize('name', sorted(COUNT_CASES))
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
def test_count_reference_matches_jax_autodiff(distribution, name):
  config, params, x_t, seasonal_t, y = _count_args(name)
  got = t_fused.fused_train_reference(
      distribution, **_k1_args(config, params, x_t, seasonal_t, y,
                               torch.as_tensor))
  members = params[0].shape[0]
  rows = [jnp.asarray(np.stack(_member_rows(a, nd, members)))
          for a, nd in ((x_t, 2), (seasonal_t, 2), (y, 1))]
  dist = j_likelihoods.LikelihoodDist(distribution)

  def member_loss(p, xm, sm, ym):
    pred = j_field.apply_field_t(config, p, xm, sm)
    return -LIK_SCALE * j_likelihoods.log_likelihood(dist, p, pred, ym)

  j_params = tuple(jnp.asarray(p) for p in params)
  want_losses = jax.vmap(member_loss)(j_params, *rows)
  want_grads = jax.grad(
      lambda ps: jax.vmap(member_loss)(ps, *rows).sum())(j_params)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want_losses),
                             rtol=LOSS_RTOL)
  _assert_unused_obs_zero(distribution, got)
  got_slots = _by_slot(config, got)
  for slot, w in enumerate(want_grads):
    np.testing.assert_allclose(got_slots[slot], np.asarray(w), **GRAD_TOL,
                               err_msg=f'slot {slot}')


def _checked(args, distribution='NORMAL', **changes):
  args = dict(args, **changes)
  return t_fused._check_train_inputs(  # pylint: disable=protected-access
      args['depth'], args['input_scales'], args['fourier_degrees'],
      args['interactions'], args['x_t'], args['seasonal_t'], args['weights'],
      args['biases'], args['lsa'], args['fs_raw'], args['scales_raw'],
      args['logit'], args['obs_raw'], args['y'], distribution)


def test_input_checks():
  config, _, args = _torch_args('depth2-seasonal-interactions')
  assert _checked(args) == (16, config.encoded_dim, config.num_feature_groups)
  with pytest.raises(ValueError, match='shape'):
    _checked(args, fs_raw=args['fs_raw'][:, :-1].contiguous())
  with pytest.raises(ValueError, match='shape'):
    _checked(args, y=args['y'][:-1].contiguous())
  with pytest.raises(ValueError, match='float32'):
    _checked(args, lsa=args['lsa'].double())
  w0 = args['weights'][0]
  with pytest.raises(ValueError, match='contiguous'):
    _checked(args, weights=(w0.transpose(1, 2).contiguous().transpose(1, 2),
                            *args['weights'][1:]))
  with pytest.raises(ValueError, match='weights and biases'):
    _checked(args, depth=1)
  with pytest.raises(ValueError, match='inputs'):
    _checked(args, input_scales=args['input_scales'][:2])
  with pytest.raises(ValueError, match='interaction'):
    _checked(args, interactions=((0, 3),))
  with pytest.raises(ValueError, match='2 or 3 dims'):
    _checked(args, x_t=args['x_t'][None, None])
  with pytest.raises(ValueError, match='shape'):
    # Per-member rows of another length than x_t's.
    _checked(args, y=torch.zeros((3, N_ROWS - 1)))


def test_scatter_matches_jax():
  config, _, args = _torch_args('depth3-interactions')
  outs = t_fused.fused_train_reference('NORMAL', **args)
  got = t_field.scatter_fused_train_grads(
      t_field.FieldConfig.create(
          width=16, depth=3, input_scales=[50.0, 1.0, 1.0],
          fourier_degrees=[3, 2, 0], interactions=[(0, 2)],
          seasonality_periods=[], num_seasonal_harmonics=[]),
      *outs[1:])
  want = _by_slot(config, outs)
  assert len(got) == len(want) == len(j_field.param_specs(config))
  for slot, g in enumerate(got):
    np.testing.assert_array_equal(g.numpy(), want[slot])


class _FakeTrainLib:
  """Stands in for the compiled K1 library on the CPU: the C side's scratch
  formula (per chunk row and member lhs_l, z_l, dv_l and dh_0; per 128-row
  tile the scalar partials, and per hidden layer and 128-column block two
  sums; under 'bf16' also per chunk row and member the bf16 twins of lhs_l
  and dv_l for l < depth, and per member the hidden weights' bf16 copies,
  rows padded to a multiple of 8), and a launch that records its arguments
  and returns `err`."""

  def __init__(self, err=0):
    self.err = err
    self.calls = []

  @staticmethod
  def bnf_fused_train_scratch_bytes(members, num_features, width, depth,
                                    num_inputs, num_groups, chunk_rows,
                                    n_rows, likelihood=0, precision=0):
    tiles = -(-n_rows // 128)
    partials = 2 + num_inputs + num_groups + 2 * (likelihood > 0)
    layer_sums = 2 * depth * -(-width // 128)
    bf16 = 0
    if precision == 1 and depth:
      twins = num_features + (2 * depth - 1) * width
      copies = (num_features + (depth - 1) * width) * (-(-width // 8) * 8)
      bf16 = members * (chunk_rows * twins + copies) * 2
    return (members * chunk_rows * (2 * num_features + 3 * depth * width + 1)
            + members * tiles * (partials + layer_sums)) * 4 + bf16

  def bnf_fused_train(self, *args):
    self.calls.append(args)
    return self.err

  @staticmethod
  def bnf_cuda_error_string(err):
    return f'error {err}'.encode()


def test_launch_plans_tiles_chunks_and_outputs(monkeypatch):
  config, _, args = _torch_args('depth2-seasonal-interactions')
  dims = _checked(args)
  f = config.encoded_dim
  launch = lambda lib: t_fused._launch_fused_train(  # pylint: disable=protected-access
      lib, 'stream', dims, **args, distribution='NORMAL')
  lib = _FakeTrainLib()
  outs = launch(lib)
  *_, n_valid, chunk_rows, stream = lib.calls[-1]
  # All 70 rows fit the default budget: one chunk of one 128-row tile.
  assert (n_valid, chunk_rows, stream) == (N_ROWS, 128, 'stream')
  assert t_fused.TRAIN_ROW_TILE == 128
  np.testing.assert_allclose(list(lib.calls[-1][19]),
                             [f ** -0.5, 0.25, 0.25], rtol=1e-7)
  assert [o.shape for o in outs[3]] == [w.shape for w in args['weights']]
  assert outs[2].shape == args['fs_raw'].shape
  # A budget of 200 rows' scratch, or of less than one tile, gives one
  # 128-row tile per chunk.
  per_row = lib.bnf_fused_train_scratch_bytes(3, f, 16, 2, 3, 6, 1, 0)
  for budget_rows in (200, 40):
    monkeypatch.setattr(t_fused, 'TRAIN_SCRATCH_BYTES', budget_rows * per_row)
    launch(lib)
    assert lib.calls[-1][-2] == 128
  # A chunk holds at most MAX_TRAIN_CHUNK_TILES tiles (the GEMMs' grid):
  # 300 rows under an ample budget make one 384-row chunk, or 256-row ones.
  longer = dict(args, **{k: args[k].repeat(*([1] * (args[k].ndim - 1)), 5)[
      ..., :300].contiguous() for k in ('x_t', 'seasonal_t', 'y')})
  monkeypatch.setattr(t_fused, 'TRAIN_SCRATCH_BYTES', 1 << 40)
  for cap, chunk in ((65535, 384), (2, 256)):
    monkeypatch.setattr(t_fused, 'MAX_TRAIN_CHUNK_TILES', cap)
    t_fused._launch_fused_train(  # pylint: disable=protected-access
        lib, 'stream', _checked(longer), **longer, distribution='NORMAL')
    assert lib.calls[-1][-2] == chunk
  with pytest.raises(RuntimeError, match='error 7'):
    launch(_FakeTrainLib(err=7))
  # Shared inputs: group stride 0 and one member per group.
  assert lib.calls[0][22:28] == (0, 1, 0, 1, 0, 1)


def test_chunks_ignore_rows_past_n_valid(monkeypatch):
  # Rows past n_valid move no chunk boundary while the rows exceed the
  # budget: 256 valid rows alone, and with 13 junk rows appended, run in
  # the same 128-row chunks (the junk rows in a chunk of their own).
  _, _, args = _torch_args('depth2-seasonal-interactions')
  width, f, g = _checked(args)
  lib = _FakeTrainLib()
  per_row = lib.bnf_fused_train_scratch_bytes(3, f, width, 2, 3, g, 1, 0)
  monkeypatch.setattr(t_fused, 'TRAIN_SCRATCH_BYTES', 200 * per_row)

  def rows(t, n):
    return t.repeat(*([1] * (t.ndim - 1)), 4)[..., :n].contiguous()

  chunks = []
  for n in (256, 256 + 13):
    longer = dict(args, x_t=rows(args['x_t'], n),
                  seasonal_t=rows(args['seasonal_t'], n), y=rows(args['y'], n))
    t_fused._launch_fused_train(  # pylint: disable=protected-access
        lib, 'stream', _checked(longer), **longer, distribution='NORMAL',
        n_valid=256)
    chunks.append(lib.calls[-1][-2])
    assert lib.calls[-1][-3] == 256  # n_valid
  assert chunks == [128, 128]


def test_bf16_chunks_count_the_twins_and_ignore_rows_past_n_valid(
    monkeypatch):
  # A budget of 300 fp32 rows' scratch: 'f32' runs 256-row chunks, while a
  # 'bf16' row also holds its bf16 twins and the call the weights' bf16
  # copies, so 'bf16' runs 128-row chunks; rows past n_valid move no 'bf16'
  # chunk boundary either.
  _, _, args = _torch_args('depth2-seasonal-interactions')
  width, f, g = _checked(args)
  lib = _FakeTrainLib()
  f32_row = lib.bnf_fused_train_scratch_bytes(3, f, width, 2, 3, g, 1, 0)
  fixed = lib.bnf_fused_train_scratch_bytes(3, f, width, 2, 3, g, 0, 0, 0, 1)
  bf16_row = lib.bnf_fused_train_scratch_bytes(
      3, f, width, 2, 3, g, 1, 0, 0, 1) - fixed
  assert fixed == 3 * (f + width) * 16 * 2  # W_0, W_1 rows of 16 bf16
  assert bf16_row == f32_row + 3 * (f + 3 * width) * 2
  monkeypatch.setattr(t_fused, 'TRAIN_SCRATCH_BYTES', 300 * f32_row)

  def rows(t, n):
    return t.repeat(*([1] * (t.ndim - 1)), 6)[..., :n].contiguous()

  chunks = {}
  for precision, n in (('f32', 512), ('bf16', 512), ('bf16', 512 + 13)):
    longer = dict(args, x_t=rows(args['x_t'], n),
                  seasonal_t=rows(args['seasonal_t'], n), y=rows(args['y'], n))
    t_fused._launch_fused_train(  # pylint: disable=protected-access
        lib, 'stream', _checked(longer), **longer, distribution='NORMAL',
        precision=precision, n_valid=512)
    chunks[precision, n] = lib.calls[-1][-2]
    assert lib.calls[-1][-3] == 512  # n_valid
  assert chunks == {('f32', 512): 256, ('bf16', 512): 128,
                    ('bf16', 525): 128}


def test_k1_takes_any_width_k2_does_not(monkeypatch):
  # Neither K1's tiles nor K2's depend on the width (both run layer-wise):
  # 'auto' picks 'kernel' for a width-2048 fit and for a width-2048 predict
  # from the shapes alone, building no library (the name is older than K2's
  # layer-wise plan, under which K2 no longer refuses a width). Only the
  # depth limits K2.
  from bayesnf_torch.inference import backends as t_backends  # pylint: disable=g-import-not-at-top

  def no_library(*_):
    raise AssertionError('kernel_takes built a library')

  monkeypatch.setattr(t_fused._build, 'load_library', no_library)  # pylint: disable=protected-access
  config = dict(
      width=2048, depth=2, input_scales=[50.0, 1.0, 1.0],
      fourier_degrees=[5, 5, 5], interactions=[],
      seasonality_periods=[24.0, 168.0], num_seasonal_harmonics=[4, 4])
  wide = t_field.FieldConfig.create(**config)
  for distribution in ('NORMAL', 'NB', 'ZINB'):
    assert t_backends.kernel_takes(wide, distribution)
    assert t_backends.resolve_backend('auto', 'cuda', wide,
                                      distribution) == 'kernel'
  assert t_fused.check_train_shape(
      'NORMAL', 2, 2048, wide.fourier_degrees, (), 16) == (2048, 49, 5)
  assert t_backends.kernel_takes(wide)
  assert t_backends.resolve_backend('auto', 'cuda', wide) == 'kernel'
  deep = t_field.FieldConfig.create(**dict(config, width=512,
                                           depth=t_fused.MAX_DEPTH + 1))
  assert not t_backends.kernel_takes(deep)
  assert t_backends.resolve_backend('auto', 'cuda', deep) == 'torch'


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_launch_passes_group_strides_and_reps(layout):
  config, params, inputs = _grouped_args(layout)
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  lib = _FakeTrainLib()
  t_fused._launch_fused_train(  # pylint: disable=protected-access
      lib, 'stream', _checked(args), **args, distribution='NORMAL')
  want = []
  for a, count in zip(inputs, LAYOUTS[layout]):
    want += [0, 1] if count is None else [a[0].size, GROUPED_MEMBERS // count]
  assert list(lib.calls[-1][22:28]) == want


@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_launch_passes_the_likelihood_and_its_partials(distribution):
  config, params, inputs = _grouped_args('grouped-rep2')
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  lib = _FakeTrainLib()
  dims = _checked(args, distribution)
  t_fused._launch_fused_train(  # pylint: disable=protected-access
      lib, 'stream', dims, **args, distribution=distribution)
  code = t_fused.LIKELIHOOD_CODES[distribution]
  assert lib.calls[-1][28:30] == (LIK_SCALE, code)
  extra = 0 if distribution == 'NORMAL' else 2
  f, g = dims[1:]
  assert t_fused.num_partials(3, g, distribution) == 2 + 3 + g + extra
  # The largest field the kernel takes (8 inputs with Fourier features,
  # seasonal rows and interactions: 11 groups; the depth adds none) fits
  # the per-tile partials under every likelihood.
  assert t_fused.num_partials(
      t_fused.MAX_INPUTS, t_fused.MAX_INPUTS + 3,
      distribution) <= t_fused.MAX_PARTIALS
  assert f == config.encoded_dim


# 'bf16' against the JAX package's 'bf16': both round the same fp32 values,
# but values an ulp apart can round to neighbouring bf16 values (~0.4% on
# one term of a fan-in sum), so the JAX package's count bounds: losses rtol
# 1e-3, each gradient leaf within 2e-3 of its largest magnitude. Against
# fp32 the JAX package's bf16 bound (`tests/test_fused_mlp.py`): rtol 2e-2
# plus 2e-2 of the leaf's largest magnitude.
BF16_LOSS_RTOL = 1e-3
BF16_LEAF_TOL = 2e-3
BF16_F32_TOL = 2e-2
BF16_DEPTHS = {1: 'depth1-seasonal', 2: 'depth2-seasonal-interactions'}
BF16_LAYOUTS = ('shared', 'per-member', 'grouped-rep2')


def _bf16_inputs(distribution, layout, depth):
  """(JAX config, params, numpy x_t, seasonal_t, y) at `depth`, shared or
  in `LAYOUTS[layout]`; count targets for NB and ZINB."""
  case = BF16_DEPTHS[depth]
  if layout == 'shared':
    config, params, x_t, seasonal_t, y = _setup(**CASES[case])
  else:
    config, params, (x_t, seasonal_t, y) = _grouped_args(layout, case)
  if distribution != 'NORMAL':
    y = _counts(y.shape, np.random.default_rng(7))
  return config, params, x_t, seasonal_t, y


def _assert_leaves_within(got_slots, want_slots, tol):
  for slot, w in want_slots.items():
    err = np.abs(got_slots[slot] - w).max()
    assert err <= tol * np.abs(w).max(), (slot, err, np.abs(w).max())


@pytest.mark.parametrize('depth', sorted(BF16_DEPTHS))
@pytest.mark.parametrize('layout', BF16_LAYOUTS)
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_bf16_reference_matches_pallas_interpret(distribution, layout, depth):
  config, params, *inputs = _bf16_inputs(distribution, layout, depth)
  got = t_fused.fused_train_reference(
      distribution, **_k1_args(config, params, *inputs, torch.as_tensor),
      precision='bf16')
  j_args = _k1_args(config, params, *inputs, jnp.asarray)
  want = j_fused.fused_train(distribution, j_args.pop('depth'), TILE,
                             **j_args, precision='bf16')
  np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                             rtol=BF16_LOSS_RTOL)
  _assert_leaves_within(_by_slot(config, got), _by_slot(config, want),
                        BF16_LEAF_TOL)


@pytest.mark.parametrize('depth', sorted(BF16_DEPTHS))
@pytest.mark.parametrize('layout', BF16_LAYOUTS)
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_bf16_reference_is_near_f32(distribution, layout, depth):
  config, params, *inputs = _bf16_inputs(distribution, layout, depth)
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  got = t_fused.fused_train_reference(distribution, **args, precision='bf16')
  want = t_fused.fused_train_reference(distribution, **args)
  np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                             rtol=BF16_F32_TOL)
  got_slots, want_slots = _by_slot(config, got), _by_slot(config, want)
  rounded = False
  for slot, w in want_slots.items():
    g = got_slots[slot]
    np.testing.assert_allclose(g, w, rtol=BF16_F32_TOL,
                               atol=BF16_F32_TOL * np.abs(w).max(),
                               err_msg=f'slot {slot}')
    rounded |= not np.array_equal(g, w)
  assert rounded


@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
def test_highest_is_f32_bit_for_bit(distribution):
  config, params, *inputs = _bf16_inputs(distribution, 'grouped-rep2', 2)
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  f32 = t_fused.fused_train(distribution, **args)
  highest = t_fused.fused_train(distribution, **args, precision='highest')
  for g, w in zip(_by_slot(config, highest).values(),
                  _by_slot(config, f32).values()):
    np.testing.assert_array_equal(g, w)
  np.testing.assert_array_equal(highest[0].numpy(), f32[0].numpy())
  # On CPU tensors the wrapper is the plain version at every precision.
  bf16 = t_fused.fused_train(distribution, **args, precision='bf16')
  want = t_fused.fused_train_reference(distribution, **args, precision='bf16')
  for g, w in zip(_by_slot(config, bf16).values(),
                  _by_slot(config, want).values()):
    np.testing.assert_array_equal(g, w)


def test_bf16_output_weight_gradient_stays_fp32():
  # K1 rounds every product but the output layer's weight gradient (its
  # cotangent has one column): that leaf is the fp32 sum of the fp32
  # lhs_out dv_out, given the bf16 forward. The XLA path
  # (`field.mlp_t(precision='bf16')` without `k1_sites`) rounds it too.
  config, params, *inputs = _bf16_inputs('NORMAL', 'shared', 2)
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  k1 = t_fused.fused_train_reference('NORMAL', **args, precision='bf16')
  leaves = [t.detach().requires_grad_(True) for t in args['weights']]
  groups = t_field.encode_raw_t(
      args['input_scales'], args['fourier_degrees'], args['interactions'],
      args['lsa'], args['fs_raw'], args['x_t'], args['seasonal_t'])
  pred = t_field.mlp_t(2, groups, leaves, args['biases'], args['scales_raw'],
                       args['logit'], precision='bf16')
  loss = -LIK_SCALE * t_fused.likelihoods.log_likelihood(
      t_fused.likelihoods.LikelihoodDist.NORMAL, args['obs_raw'].unbind(-1),
      pred, args['y'])
  xla = torch.autograd.grad(loss.sum(), leaves)
  for l in range(2):  # The hidden layers round at the same sites.
    np.testing.assert_allclose(k1[3][l].numpy(), xla[l].numpy(), rtol=1e-5,
                               atol=1e-6 * xla[l].abs().max().item())
  assert not torch.equal(k1[3][2], xla[2])
  np.testing.assert_allclose(k1[3][2].numpy(), xla[2].numpy(),
                             rtol=BF16_F32_TOL,
                             atol=BF16_F32_TOL * xla[2].abs().max().item())


@pytest.mark.parametrize('precision', ['f32', 'highest', 'bf16'])
def test_launch_passes_the_precision(precision):
  config, params, inputs = _grouped_args('grouped-rep2')
  args = _k1_args(config, params, *inputs, torch.as_tensor)
  lib = _FakeTrainLib()
  t_fused._launch_fused_train(  # pylint: disable=protected-access
      lib, 'stream', _checked(args), **args, distribution='NORMAL',
      precision=precision)
  code, depth = lib.calls[-1][30:32]
  assert code == t_fused.PRECISION_CODES[precision] == (precision == 'bf16')
  # The kernel rounds where it stages each product's operands: the call
  # passes no buffers for rounded weights at any precision.
  assert depth == config.depth
  assert len(lib.calls[-1]) == 41


@pytest.mark.parametrize('layout', sorted(t_fused.TC_LAYOUTS))
def test_tc_gemm_on_cpu_is_the_plain_product(layout):
  # K1's tensor-core GEMM core takes its operands in the layout of one of
  # K1's 'bf16' products; on CPU tensors it is the plain product of the
  # logical (M, K) and (K, N) matrices, which an fp64 product of the same
  # bf16 values bounds (fp32 sums: 1e-5 of the products' magnitudes).
  rng = np.random.default_rng(3)
  e, m, n, k = 2, 49, 20, 37
  a_mk = rng.normal(size=(e, m, k)).astype(np.float32)
  b_kn = rng.normal(size=(e, k, n)).astype(np.float32)
  stored = {'forward': (a_mk.transpose(0, 2, 1), b_kn),
            'wdv': (a_mk, b_kn),
            'wgrad': (a_mk, b_kn.transpose(0, 2, 1))}[layout]
  a, b = [torch.from_numpy(np.pad(s, ((0, 0), (0, 0), (0, 3)))).bfloat16()
          for s in stored]
  got = t_fused.tc_gemm(layout, a, b, m, n, k)
  a64, b64 = [t.float().double().numpy() for t in (a, b)]
  a64 = a64.transpose(0, 2, 1) if layout == 'forward' else a64
  b64 = b64.transpose(0, 2, 1) if layout == 'wgrad' else b64
  a64, b64 = a64[:, :m, :k], b64[:, :k, :n]
  want = a64 @ b64
  assert got.shape == (e, m, n) and got.dtype == torch.float32
  assert (np.abs(got.numpy() - want) <= 1e-5 * (np.abs(a64) @ np.abs(b64))
          ).all()
  with pytest.raises(ValueError, match='unknown layout'):
    t_fused.tc_gemm('rows', a, b, m, n, k)
