"""The port's CUDA kernels and CUDA serving and training paths, on a card.

Every test here is marked `gpu` and skips without a CUDA device. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py -q

(`--noconftest` skips `tests/conftest.py`, which needs JAX.)
"""

import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import bayesnf_torch
from bayesnf_torch.models import field
from bayesnf_torch.ops import fused_mlp
from bayesnf_torch.ops import mixed
from bayesnf_torch.parallel import mesh as mesh_lib

DATA = pathlib.Path(__file__).resolve().parent / 'test_data'
# fp32 sums over fan-in <= 1024 taken in another order than torch.matmul.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(name='cuda')
def _cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


def _inputs(depth, groups, n, width, members, device, seed=0):
  rng = np.random.default_rng(seed)
  fan_ins = [sum(groups)] + [width] * depth
  fan_outs = [width] * depth + [1]

  def put(a):
    return torch.as_tensor(a.astype(np.float32), device=device)

  return dict(
      h0_groups=[put(rng.uniform(-1, 1, (members, g, n))) for g in groups],
      weights=[put(np.clip(rng.normal(size=(members, fi, fo)), -2, 2))
               for fi, fo in zip(fan_ins, fan_outs)],
      biases=[put(rng.normal(scale=0.3, size=(members, fo)))
              for fo in fan_outs],
      scales_raw=put(rng.normal(scale=0.5, size=(members, depth + 1))),
      logit=put(rng.normal(size=(members,))),
  )


@pytest.mark.gpu
@pytest.mark.parametrize('depth,width,n', [
    (2, 64, 333), (1, 256, 70), (3, 32, 65), (0, 1, 40), (2, 1024, 17),
])
def test_kernel_matches_plain(cuda, depth, width, n):
  args = _inputs(depth, (3, 10, 6), n, width, members=3, device=cuda)
  before = fused_mlp.fused_field_mlp_t.launches
  got = fused_mlp.fused_field_mlp_t(depth, **args)
  torch.cuda.synchronize()
  assert fused_mlp.fused_field_mlp_t.launches == before + 1
  want = fused_mlp.fused_field_mlp_t_reference(depth, **args)
  torch.testing.assert_close(got, want, **KERNEL_TOL)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take(cuda):
  # K2 runs layer-wise, so any width fits (4,096 here, past what the old
  # tile kernel's shared memory held); tensors on two devices do not.
  args = _inputs(1, (5,), 8, 4096, members=2, device=cuda)
  torch.testing.assert_close(
      fused_mlp.fused_field_mlp_t(1, **args),
      fused_mlp.fused_field_mlp_t_reference(1, **args), **KERNEL_TOL)
  args = _inputs(1, (5,), 8, 16, members=2, device=cuda)
  args['logit'] = args['logit'].cpu()
  with pytest.raises(ValueError, match='must be on'):
    fused_mlp.fused_field_mlp_t(1, **args)


@pytest.mark.gpu
def test_served_predict_on_cuda_matches_torch_backend(cuda):
  model = bayesnf_torch.BayesianNeuralFieldMAP.load(
      str(DATA / 'bnf-map.chickenpox.8.port.npz'), device=cuda)
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  before = fused_mlp.fused_field_mlp_t.launches
  means, quantiles = model.predict(table, quantiles=(0.5, 0.975))
  assert fused_mlp.fused_field_mlp_t.launches == before + 1
  t_means, t_quantiles = model.predict(table, quantiles=(0.5, 0.975),
                                       backend='torch')
  assert means.device.type == 'cuda'
  torch.testing.assert_close(means, t_means, **KERNEL_TOL)
  noise = 0.01 + torch.exp(model.params_[0]).max().item()
  for got, want in zip(quantiles, t_quantiles):
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-3 * noise)


def _train_inputs(depth, width, n, members, device, seasonal=True,
                  interactions=((0, 1), (1, 2)), seed=0, groups=None):
  """K1 arguments from a small field config, scaled like an initialized
  model; with `groups`, x, seasonal rows and y hold `groups` row sets of
  their own (member m reads set m // (members // groups))."""
  config = field.FieldConfig.create(
      width=width, depth=depth, input_scales=[float(n), 1.0, 1.0],
      fourier_degrees=[3, 2, 0], interactions=list(interactions),
      seasonality_periods=[7.0] if seasonal else [],
      num_seasonal_harmonics=[2] if seasonal else [])
  rng = np.random.default_rng(seed)
  x = np.stack([np.arange(n), rng.normal(size=n), rng.normal(size=n)], 1)
  aug = field.aug_features(
      config, torch.as_tensor(x.astype(np.float32), device=device)).T
  params = [
      torch.as_tensor(
          (np.clip(rng.normal(size=(members,) + s.shape), -2, 2)
           if s.is_matrix else 0.1 * rng.normal(size=(members,) + s.shape)
           ).astype(np.float32), device=device)
      for s in field.param_specs(config)]
  weights, biases = field.dense_params(config, params)
  d = config.num_inputs
  args = dict(
      distribution='NORMAL', depth=depth, lik_scale=1.0,
      input_scales=config.input_scales,
      fourier_degrees=config.fourier_degrees,
      interactions=config.interactions,
      x_t=aug[:d].contiguous(), seasonal_t=aug[d:].contiguous(),
      weights=weights, biases=biases, lsa=params[3], fs_raw=params[4],
      scales_raw=params[6], logit=params[5],
      obs_raw=torch.stack(params[:3], dim=-1).contiguous(),
      y=torch.as_tensor(rng.normal(size=n).astype(np.float32),
                        device=device))
  if groups is not None:
    sets = [_train_inputs(depth, width, n, members, device, seasonal,
                          interactions, seed=seed + 1 + i)
            for i in range(groups)]
    args.update({k: torch.stack([a[k] for a in sets])
                 for k in ('x_t', 'seasonal_t', 'y')})
  return args


def _flat(outs):
  losses, dlsa, dfs, dws, dbs, dscales, dlogit, dobs = outs
  return [losses, dlsa, dfs, *dws, *dbs, dscales, dlogit, dobs]


@pytest.mark.gpu
@pytest.mark.parametrize('depth,width,n,seasonal,interactions', [
    (2, 64, 333, True, ((0, 1), (1, 2))),
    (1, 256, 70, True, ()),
    (3, 32, 65, False, ((0, 2),)),
    (0, 1, 40, True, ()),
    (2, 1024, 17, False, ()),
])
def test_train_kernel_matches_plain(cuda, depth, width, n, seasonal,
                                    interactions):
  args = _train_inputs(depth, width, n, 3, cuda, seasonal, interactions)
  before = fused_mlp.fused_train.launches
  got = fused_mlp.fused_train(**args)
  torch.cuda.synchronize()
  assert fused_mlp.fused_train.launches == before + 1
  want = fused_mlp.fused_train_reference(**args)
  torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
  for g, w in zip(_flat(got)[1:], _flat(want)[1:]):
    # 2e-4 of each leaf's largest magnitude (see chip_smoke.py).
    assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item()
  assert bool((got[-1][:, 1:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize('depth,width,n,members,groups', [
    (2, 64, 333, 6, 2),  # grouped: rep 3
    (1, 256, 70, 4, 4),  # per member: rep 1
    (2, 32, 65, 5, 1),  # one group for every member
], ids=['grouped-rep3', 'per-member', 'one-group'])
def test_train_kernel_grouped_inputs_match_plain(cuda, depth, width, n,
                                                 members, groups):
  args = _train_inputs(depth, width, n, members, cuda, groups=groups)
  assert args['x_t'].shape[0] == groups
  before = fused_mlp.fused_train.launches
  got = fused_mlp.fused_train(**args)
  torch.cuda.synchronize()
  assert fused_mlp.fused_train.launches == before + 1
  want = fused_mlp.fused_train_reference(**args)
  torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
  for g, w in zip(_flat(got)[1:], _flat(want)[1:]):
    assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item()


def _with_counts(args, distribution, seed=0):
  """`args` with count targets of the same layout, for NB or ZINB."""
  rng = np.random.default_rng(seed)
  y = rng.poisson(rng.gamma(2.0, 4.0, size=tuple(args['y'].shape)))
  y.reshape(-1)[::7] = 0
  return dict(args, distribution=distribution, y=torch.as_tensor(
      y.astype(np.float32), device=args['y'].device))


@pytest.mark.gpu
@pytest.mark.parametrize('distribution', ['NB', 'ZINB'])
@pytest.mark.parametrize('depth,width,n,members,groups', [
    (2, 64, 333, 3, None),
    (1, 256, 70, 3, None),
    (2, 1024, 17, 3, None),
    (2, 64, 333, 6, 2),
    (1, 256, 70, 4, 4),
], ids=['shared', 'shared-depth1', 'width1024', 'grouped-rep3', 'per-member'])
def test_train_kernel_count_models_match_plain(cuda, distribution, depth,
                                               width, n, members, groups):
  # The kernel evaluates the TPU kernel's Stirling series, the plain version
  # the exact log-gamma: the JAX package's count bounds (losses rtol 1e-3,
  # each leaf within 2e-3 of its largest magnitude).
  args = _with_counts(_train_inputs(depth, width, n, members, cuda,
                                    groups=groups), distribution)
  before = fused_mlp.fused_train.launches
  got = fused_mlp.fused_train(**args)
  torch.cuda.synchronize()
  assert fused_mlp.fused_train.launches == before + 1
  want = fused_mlp.fused_train_reference(**args)
  torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=0)
  for g, w in zip(_flat(got)[1:], _flat(want)[1:]):
    assert bool(torch.isfinite(g).all())
    assert (g - w).abs().max().item() <= 2e-3 * w.abs().max().item()
  unused = [0, 2] if distribution == 'NB' else [0]
  assert bool((got[-1][:, unused] == 0).all())


# 'bf16' kernel against 'bf16' plain version: both round the same fp32
# values, but values an ulp apart can round to neighbouring bf16 values, so
# the JAX package's count bounds (losses rtol 1e-3, each leaf within 2e-3 of
# its largest magnitude); against the fp32 plain version the JAX package's
# bf16 bound (rtol 2e-2 and 2e-2 of the leaf's largest magnitude).
BF16_LOSS_RTOL = 1e-3
BF16_LEAF_TOL = 2e-3
BF16_F32_TOL = 2e-2


# 'bf16' shapes: (depth, width, rows, members, groups, chunked). `chunked`
# sets a scratch budget below one tile's, so every 128-row tile is a chunk
# of its own (the weight gradients add over chunks in order).
BF16_SHAPES = [
    (2, 64, 333, 3, None, False),
    (1, 256, 70, 3, None, False),
    (2, 1024, 17, 3, None, False),
    (0, 1, 40, 3, None, False),
    (2, 64, 333, 6, 2, False),
    (1, 256, 70, 4, 4, False),
    (2, 100, 333, 3, None, False),
    (3, 64, 333, 3, None, False),
    (2, 64, 333, 6, 2, True),
]
BF16_IDS = ['shared', 'shared-depth1', 'width1024', 'depth0', 'grouped-rep3',
            'per-member', 'width100', 'depth3', 'multi-chunk']


def _bf16_inputs(monkeypatch, cuda, depth, width, n, members, groups,
                 chunked):
  if chunked:
    monkeypatch.setattr(fused_mlp, 'TRAIN_SCRATCH_BYTES', 1)
  return _train_inputs(depth, width, n, members, cuda, groups=groups)


@pytest.mark.gpu
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
@pytest.mark.parametrize('depth,width,n,members,groups,chunked', BF16_SHAPES,
                         ids=BF16_IDS)
def test_train_kernel_bf16_matches_plain(cuda, monkeypatch, distribution,
                                         depth, width, n, members, groups,
                                         chunked):
  args = _bf16_inputs(monkeypatch, cuda, depth, width, n, members, groups,
                      chunked)
  if distribution != 'NORMAL':
    args = _with_counts(args, distribution)
  before = (fused_mlp.fused_train.launches, fused_mlp.fused_train.bf16_launches)
  got = fused_mlp.fused_train(**args, precision='bf16')
  torch.cuda.synchronize()
  assert (fused_mlp.fused_train.launches,
          fused_mlp.fused_train.bf16_launches) == (before[0] + 1, before[1] + 1)
  want = fused_mlp.fused_train_reference(**args, precision='bf16')
  f32 = fused_mlp.fused_train_reference(**args)
  torch.testing.assert_close(got[0], want[0], rtol=BF16_LOSS_RTOL, atol=0)
  for g, w, f in zip(_flat(got), _flat(want), _flat(f32)):
    assert bool(torch.isfinite(g).all())
    assert (g - w).abs().max().item() <= BF16_LEAF_TOL * w.abs().max().item()
    assert bool(((g - f).abs() <= BF16_F32_TOL * (
        f.abs() + f.abs().max())).all())


@pytest.mark.gpu
def test_train_kernel_highest_is_f32_bit_for_bit(cuda):
  args = _train_inputs(2, 64, 333, 3, cuda)
  bf16_before = fused_mlp.fused_train.bf16_launches
  highest = fused_mlp.fused_train(**args, precision='highest')
  f32 = fused_mlp.fused_train(**args)
  assert fused_mlp.fused_train.bf16_launches == bf16_before
  assert all(torch.equal(a, b) for a, b in zip(_flat(highest), _flat(f32)))


@pytest.mark.gpu
@pytest.mark.parametrize('depth,width,n,members,groups,chunked', [
    (2, 256, 333, 4, 2, False), *BF16_SHAPES[-3:]],
                         ids=['grouped-width256', *BF16_IDS[-3:]])
def test_train_kernel_bf16_is_reproducible(cuda, monkeypatch, depth, width,
                                           n, members, groups, chunked):
  # Fixed reduction orders and no atomics, as in fp32.
  args = _bf16_inputs(monkeypatch, cuda, depth, width, n, members, groups,
                      chunked)
  first = fused_mlp.fused_train(**args, precision='bf16')
  again = fused_mlp.fused_train(**args, precision='bf16')
  assert all(torch.equal(a, b) for a, b in zip(_flat(first), _flat(again)))


@pytest.mark.gpu
@pytest.mark.parametrize('layout,m,n,k', [
    ('forward', 100, 256, 49),
    ('wdv', 49, 200, 130),
    ('wgrad', 49, 100, 300),
])
def test_tc_gemm_matches_plain(cuda, layout, m, n, k):
  # K1's tensor-core GEMM core in each product's operand layout, at M = 49,
  # a width not a multiple of 8 and ragged K; each operand row padded with
  # NaN, which the kernel must never read. Both sum exact products in fp32
  # in other orders: within 1e-4 of the products' magnitudes.
  rng = np.random.default_rng(5)
  shapes = {'forward': ((k, m), (k, n)), 'wdv': ((m, k), (k, n)),
            'wgrad': ((m, k), (n, k))}[layout]
  a, b = [torch.nn.functional.pad(
      torch.as_tensor(rng.normal(size=(2, rows, cols)), dtype=torch.float32),
      (0, -cols % 8 + 8), value=float('nan')).bfloat16().to(cuda)
          for rows, cols in shapes]
  before = fused_mlp.tc_gemm.launches
  got = fused_mlp.tc_gemm(layout, a, b, m, n, k)
  torch.cuda.synchronize()
  assert fused_mlp.tc_gemm.launches == before + 1
  want = fused_mlp.tc_gemm_reference(layout, a, b, m, n, k)
  a_mk, b_kn = fused_mlp._tc_operands(layout, a, b, m, n, k)  # pylint: disable=protected-access
  mags = torch.matmul(a_mk.float().abs(), b_kn.float().abs())
  assert bool(torch.isfinite(got).all())
  assert bool(((got - want).abs() <= 1e-4 * mags).all())


@pytest.mark.gpu
@pytest.mark.parametrize('cls,batch_size', [
    ('BayesianNeuralFieldMAP', None),
    ('BayesianNeuralFieldMLE', 30),
    ('BayesianNeuralFieldVI', 30),
], ids=['MAP-full', 'MLE-minibatch', 'VI-minibatch'])
def test_bf16_fit_on_cuda_kernel_matches_torch_backend(cuda, cls, batch_size):
  # The two backends round at their JAX counterparts' sites, which differ
  # only in the output layer's weight gradient (fp32 in K1): the bf16 bound
  # between them; against the fp32 fit from the same seed, 2e-2.
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  extra = (dict(sample_size_divergence=4, sample_size_posterior=3)
           if cls.endswith('VI') else {})
  fits = {}
  for backend, precision in (('kernel', 'bf16'), ('torch', 'bf16'),
                             ('kernel', 'f32')):
    fused_mlp.fused_train.launches = 0
    fused_mlp.fused_train.bf16_launches = 0
    fits[backend, precision] = getattr(bayesnf_torch, cls)(
        **_chickenpox_kwargs()).fit(
            table, seed=0, ensemble_size=3, num_epochs=2,
            batch_size=batch_size, device=cuda, backend=backend,
            precision=precision, **extra).losses_
    launches = fused_mlp.fused_train.launches
    assert (launches > 0) == (backend == 'kernel')
    assert fused_mlp.fused_train.bf16_launches == (
        launches if precision == 'bf16' else 0)
  kernel, plain, f32 = fits.values()
  np.testing.assert_allclose(kernel, plain, rtol=BF16_LOSS_RTOL)
  np.testing.assert_allclose(kernel, f32, rtol=BF16_F32_TOL)


@pytest.mark.gpu
def test_train_kernel_refuses_what_it_cannot_take(cuda):
  # K1's tiles do not depend on the width: width 4,096 (the forward's
  # shared memory refuses it) runs and matches its plain version, while a
  # depth above MAX_DEPTH still raises before any launch.
  args = _train_inputs(1, 4096, 8, 2, cuda)
  got = fused_mlp.fused_train(**args)
  want = fused_mlp.fused_train_reference(**args)
  torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
  for g, w in zip(_flat(got)[1:], _flat(want)[1:]):
    assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item()
  with pytest.raises(ValueError, match='depth must be'):
    fused_mlp.check_train_shape('NORMAL', fused_mlp.MAX_DEPTH + 1, 16,
                                args['fourier_degrees'], (), 2)
  args = _train_inputs(1, 16, 8, 2, cuda)
  with pytest.raises(ValueError, match='must be on'):
    fused_mlp.fused_train(**dict(args, logit=args['logit'].cpu()))
  args = _train_inputs(1, 16, 8, 4, cuda, groups=3)
  with pytest.raises(ValueError, match='must divide the member count'):
    fused_mlp.fused_train(**args)


@pytest.mark.gpu
def test_fit_on_cuda_kernel_matches_torch_backend(cuda):
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  kwargs = dict(
      feature_cols=['datetime', 'latitude', 'longitude'],
      target_col='chickenpox', timetype='index', freq='W',
      standardize=['latitude', 'longitude'], width=64, depth=2,
      seasonality_periods=[4.0, 52.1775], num_seasonal_harmonics=[2, 10])
  fused_mlp.fused_train.launches = 0
  kernel = bayesnf_torch.BayesianNeuralFieldMAP(**kwargs).fit(
      table, seed=0, ensemble_size=4, num_epochs=6, device=cuda)
  assert fused_mlp.fused_train.launches == 6
  plain = bayesnf_torch.BayesianNeuralFieldMAP(**kwargs).fit(
      table, seed=0, ensemble_size=4, num_epochs=6, device=cuda,
      backend='torch')
  assert fused_mlp.fused_train.launches == 6
  np.testing.assert_allclose(kernel.losses_, plain.losses_, rtol=1e-4)
  means, _ = kernel.predict(table, quantiles=(0.5,))
  assert means.device.type == 'cuda' and bool(torch.isfinite(means).all())


def _chickenpox_kwargs():
  return dict(
      feature_cols=['datetime', 'latitude', 'longitude'],
      target_col='chickenpox', timetype='index', freq='W',
      standardize=['latitude', 'longitude'], width=64, depth=2,
      seasonality_periods=[4.0, 52.1775], num_seasonal_harmonics=[2, 10])


@pytest.mark.gpu
def test_minibatch_fit_on_cuda_kernel_matches_torch_backend(cuda):
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])  # 100 rows: 3 steps of 30
  fits = []
  for backend in ('kernel', 'torch'):
    fused_mlp.fused_train.launches = 0
    fits.append(bayesnf_torch.BayesianNeuralFieldMAP(
        **_chickenpox_kwargs()).fit(
            table, seed=0, ensemble_size=4, num_epochs=2, batch_size=30,
            device=cuda, backend=backend))
    assert fused_mlp.fused_train.launches == (6 if backend == 'kernel' else 0)
  np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
def test_vi_fit_on_cuda_kernel_matches_torch_backend(cuda, batch_size):
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  steps = 2 * (1 if batch_size is None else 3)
  fits = []
  for backend in ('kernel', 'torch'):
    fused_mlp.fused_train.launches = 0
    fits.append(bayesnf_torch.BayesianNeuralFieldVI(
        **_chickenpox_kwargs()).fit(
            table, seed=0, ensemble_size=3, num_epochs=2, batch_size=batch_size,
            sample_size_divergence=4, sample_size_posterior=5, device=cuda,
            backend=backend))
    assert fused_mlp.fused_train.launches == (
        steps if backend == 'kernel' else 0)
  assert fits[0].losses_.shape == (1, 3, steps)
  np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=1e-4)
  fused_mlp.fused_field_mlp_t.launches = 0
  means, _ = fits[0].predict(table, quantiles=(0.5,))
  assert fused_mlp.fused_field_mlp_t.launches == 1
  assert means.shape == (1, 5, 3, len(table))
  assert bool(torch.isfinite(means).all())


@pytest.mark.gpu
@pytest.mark.parametrize('cls,model,batch_size', [
    ('BayesianNeuralFieldMAP', 'NB', None),
    ('BayesianNeuralFieldMLE', 'ZINB', 30),
    ('BayesianNeuralFieldVI', 'ZINB', 30),
], ids=['NB-MAP-full', 'ZINB-MLE-minibatch', 'ZINB-VI-minibatch'])
def test_count_fit_on_cuda_kernel_matches_torch_backend(cuda, cls, model,
                                                        batch_size):
  # chickenpox counts; the backends differ by the count math's ~3e-4.
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  extra = (dict(sample_size_divergence=4, sample_size_posterior=3)
           if cls.endswith('VI') else {})
  fits = []
  for backend in ('kernel', 'torch'):
    fused_mlp.fused_train.launches = 0
    fits.append(getattr(bayesnf_torch, cls)(
        **dict(_chickenpox_kwargs(), observation_model=model)).fit(
            table, seed=0, ensemble_size=3, num_epochs=2,
            batch_size=batch_size, device=cuda, backend=backend, **extra))
    assert (fused_mlp.fused_train.launches > 0) == (backend == 'kernel')
  np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=1e-3)
  fused_mlp.fused_field_mlp_t.launches = 0
  means, quantiles = fits[0].predict(table, quantiles=(0.5, 0.9))
  assert fused_mlp.fused_field_mlp_t.launches == 1
  assert bool(torch.isfinite(means).all())
  assert all(torch.equal(q, torch.round(q)) for q in quantiles)


def _junk_padded(args, rows=13):
  """`args` with `rows` junk rows appended to x (9.9), the seasonal rows
  (-9.9) and y (NaN), in whatever layout they have."""

  def pad(t, value):
    return torch.cat([t, torch.full(t.shape[:-1] + (rows,), value,
                                    device=t.device)], -1).contiguous()

  return dict(args, x_t=pad(args['x_t'], 9.9),
              seasonal_t=pad(args['seasonal_t'], -9.9),
              y=pad(args['y'], float('nan')))


@pytest.mark.gpu
@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('distribution', ['NORMAL', 'NB', 'ZINB'])
@pytest.mark.parametrize('groups', [None, 2], ids=['shared', 'grouped-rep3'])
def test_train_kernel_n_valid_ignores_the_rows_past_it(cuda, groups,
                                                       distribution,
                                                       precision):
  # K1 stage 4: rows past n_valid count for nothing, NaN targets included,
  # bit for bit the call on the unpadded rows; against the plain version
  # with n_valid at the bounds of the stage's other tests.
  args = _train_inputs(2, 64, 333, 6, cuda, groups=groups)
  if distribution != 'NORMAL':
    args = _with_counts(args, distribution)
  junk = _junk_padded(args)
  before = fused_mlp.fused_train.launches
  got = fused_mlp.fused_train(**junk, n_valid=333, precision=precision)
  want = fused_mlp.fused_train(**args, precision=precision)
  torch.cuda.synchronize()
  assert fused_mlp.fused_train.launches == before + 2
  assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(want)))
  plain = fused_mlp.fused_train_reference(**junk, n_valid=333,
                                          precision=precision)
  loss_rtol, leaf_tol = ((1e-4, 2e-4) if distribution == 'NORMAL'
                         and precision == 'f32' else (1e-3, 2e-3))
  torch.testing.assert_close(got[0], plain[0], rtol=loss_rtol, atol=0)
  for g, w in zip(_flat(got)[1:], _flat(plain)[1:]):
    assert (g - w).abs().max().item() <= leaf_tol * w.abs().max().item()


@pytest.mark.gpu
def test_auto_fits_a_model_k1_does_not_take_on_torch(cuda):
  # Nine inputs: K1 holds at most eight, so 'auto' resolves to 'torch'
  # from the shapes, before any launch; explicit 'kernel' raises.
  rng = np.random.default_rng(0)
  cols = [f'x{i}' for i in range(9)]
  table = pd.DataFrame(rng.normal(size=(60, 10)), columns=cols + ['y'])
  kwargs = dict(feature_cols=cols, target_col='y', timetype='float',
                width=16, depth=2)
  fused_mlp.fused_train.launches = 0
  est = bayesnf_torch.BayesianNeuralFieldMAP(**kwargs).fit(
      table, seed=0, ensemble_size=2, num_epochs=3, device=cuda)
  assert fused_mlp.fused_train.launches == 0
  assert np.isfinite(est.losses_).all()
  with pytest.raises(ValueError, match='1 to 8 inputs'):
    bayesnf_torch.BayesianNeuralFieldMAP(**kwargs).fit(
        table, seed=0, ensemble_size=2, num_epochs=1, device=cuda,
        backend='kernel')


@pytest.mark.gpu
@pytest.mark.parametrize('batch_size', [None, 30], ids=['full', 'minibatch'])
def test_mesh_fit_on_one_card_matches_torch_backend(cuda, batch_size):
  # A (1, 2) mesh of the one card, 99 rows: 50 / 49, so the second shard's
  # K1 call masks a padded row through n_valid. Two K1 calls a step.
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime']).iloc[:99]
  mesh = mesh_lib.default_mesh([cuda] * 2, data_devices=2)
  steps = 2 * (1 if batch_size is None else 3)
  fits = []
  for backend in ('kernel', 'torch'):
    fused_mlp.fused_train.launches = 0
    fits.append(bayesnf_torch.BayesianNeuralFieldMAP(
        **_chickenpox_kwargs()).fit(
            table, seed=0, ensemble_size=4, num_epochs=2,
            batch_size=batch_size, mesh=mesh, backend=backend))
    assert fused_mlp.fused_train.launches == (
        2 * steps if backend == 'kernel' else 0)
  np.testing.assert_allclose(fits[0].losses_, fits[1].losses_, rtol=1e-4)
  assert fits[0].params_[7].shape[:2] == (2, 2)
  means, _ = fits[0].predict(table, quantiles=(0.5,))
  alone = fits[0].mesh_
  fits[0].mesh_ = None
  want, _ = fits[0].predict(table, quantiles=(0.5,))
  fits[0].mesh_ = alone
  torch.testing.assert_close(means, want, rtol=2e-5, atol=1e-4)


# The differentiable field MLP: K2 and K3 (features-major), K4a and K4b
# (row-major). Each leaf of the backward within 2e-4 of its largest
# magnitude (fp32 sums over rows and fan-ins in other orders); at 'bf16'
# within 2e-3 of the plain 'bf16' version (fp32 values an ulp apart may
# round to neighbouring bf16 values), and the prediction within 2e-2 of the
# plain fp32 one.
MLP_LEAF_TOL = {'f32': 2e-4, 'bf16': 2e-3}
BF16_F32_TOL = 2e-2


def _mlp_leaves(args, layout):
  h0 = (args['h0_groups'] if layout == 'features'
        else [torch.cat(args['h0_groups'], 1).transpose(1, 2).contiguous()])
  return [t.detach().clone().requires_grad_(True) for t in (
      *h0, *args['weights'], *args['biases'], args['scales_raw'],
      args['logit'])]


def _mlp_call(fn, layout, depth, leaves, precision):
  num_g = len(leaves) - 2 * (depth + 1) - 2
  num_w = depth + 1
  h0 = leaves[:num_g] if layout == 'features' else leaves[0]
  return fn(depth, h0, leaves[num_g : num_g + num_w],
            leaves[num_g + num_w : num_g + 2 * num_w], leaves[-2],
            leaves[-1], precision)


def _assert_leaves_close(got, want, tol):
  for g, w in zip(got, want):
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    assert (g - w).abs().max().item() <= tol * w.abs().max().item() + 1e-30


@pytest.mark.gpu
@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('layout', ['features', 'rows'])
@pytest.mark.parametrize('depth,width,n', [
    (2, 64, 333), (1, 256, 70), (3, 32, 65), (0, 1, 40), (2, 1024, 17),
])
def test_field_mlp_kernels_and_their_gradients_match_plain(
    cuda, layout, precision, depth, width, n):
  # Autograd through the kernels' entry point on CUDA (K2 + K3, or K4a +
  # K4b) against autograd through the plain versions.
  args = _inputs(depth, (3, 10, 6), n, width, members=3, device=cuda)
  fn, plain = {'features': (fused_mlp.fused_field_mlp_t,
                            fused_mlp.fused_field_mlp_t_reference),
               'rows': (fused_mlp.fused_field_mlp,
                        fused_mlp.fused_field_mlp_reference)}[layout]
  g = torch.as_tensor(np.random.default_rng(1).normal(size=(3, n)).astype(
      np.float32), device=cuda)
  results = {}
  for name, f, prec in (('kernel', fn, precision), ('plain', plain, precision),
                        ('f32', plain, 'f32')):
    leaves = _mlp_leaves(args, layout)
    before = (fn.launches, fn.bwd_launches)
    with mixed.fp32_matmuls():
      pred = _mlp_call(f, layout, depth, leaves, prec)
      grads = torch.autograd.grad(pred, leaves, g, allow_unused=True,
                                  materialize_grads=True)
    torch.cuda.synchronize()
    kernel = name == 'kernel'
    assert (fn.launches, fn.bwd_launches) == (before[0] + kernel,
                                              before[1] + kernel)
    results[name] = [pred.detach(), *grads]
  if precision == 'f32':
    torch.testing.assert_close(results['kernel'][0], results['plain'][0],
                               **KERNEL_TOL)
  _assert_leaves_close(results['kernel'], results['plain'],
                       MLP_LEAF_TOL[precision])
  if precision == 'bf16':
    # The prediction against fp32. (A gradient summed over these few rows,
    # such as d logit, can cancel to far below its terms, and bf16 moves it
    # further from fp32 in the plain version as well.)
    got, want = results['kernel'][0], results['f32'][0]
    off = (got - want).abs() - BF16_F32_TOL * want.abs()
    assert off.max().item() <= BF16_F32_TOL * want.abs().max().item()


@pytest.mark.gpu
def test_grad_through_fused_field_mlp_t_on_cuda_is_the_kernels(cuda):
  # torch.autograd.grad through the features-major entry point on CUDA
  # returns the gradients of the plain version (not a missing graph), and
  # they are K3's: the same as its direct call, bit for bit.
  args = _inputs(2, (3, 10, 6), 100, 64, members=2, device=cuda)
  leaves = _mlp_leaves(args, 'features')
  before = fused_mlp.fused_field_mlp_t.bwd_launches
  pred = _mlp_call(fused_mlp.fused_field_mlp_t, 'features', 2, leaves, 'f32')
  assert pred.grad_fn is not None
  loss = (pred * torch.linspace(0.5, 1.5, 100, device=cuda)).sum()
  grads = torch.autograd.grad(loss, leaves)
  assert fused_mlp.fused_field_mlp_t.bwd_launches == before + 1
  g = torch.linspace(0.5, 1.5, 100, device=cuda).expand(2, 100).contiguous()
  dh0, dws, dbs, dscales, dlogit = fused_mlp.fused_field_mlp_t_vjp_reference(
      2, args['h0_groups'], args['weights'], args['biases'],
      args['scales_raw'], args['logit'], g)
  _assert_leaves_close(grads, [*dh0, *dws, *dbs, dscales, dlogit], 2e-4)
  before = fused_mlp.fused_field_mlp_t.bwd_launches
  dh0, dws, dbs, dscales, dlogit = fused_mlp.fused_field_mlp_t_vjp(
      2, args['h0_groups'], args['weights'], args['biases'],
      args['scales_raw'], args['logit'], g)
  assert fused_mlp.fused_field_mlp_t.bwd_launches == before + 1
  assert all(torch.equal(a, b) for a, b in zip(
      grads, (*dh0, *dws, *dbs, dscales, dlogit)))


@pytest.mark.gpu
def test_predict_launches_no_backward(cuda):
  model = bayesnf_torch.BayesianNeuralFieldMAP.load(
      str(DATA / 'bnf-map.chickenpox.8.port.npz'), device=cuda)
  table = pd.read_csv(DATA / 'chickenpox.8.train.csv', index_col=0,
                      parse_dates=['datetime'])
  before = (fused_mlp.fused_field_mlp_t.launches,
            fused_mlp.fused_field_mlp_t.bwd_launches)
  means, _ = model.predict(table, quantiles=(0.5,))
  assert means.grad_fn is None
  assert (fused_mlp.fused_field_mlp_t.launches,
          fused_mlp.fused_field_mlp_t.bwd_launches) == (before[0] + 1,
                                                        before[1])


@pytest.mark.gpu
def test_field_mlp_refuses_what_it_cannot_take(cuda):
  # Both layouts run layer-wise, so widths 4,096 and 1,350 (past what the
  # old row-major tile kernels' shared memory held) run forward and
  # backward with finite gradients; an unknown precision raises.
  for layout, fn in (('features', fused_mlp.fused_field_mlp_t),
                     ('rows', fused_mlp.fused_field_mlp)):
    for width in (4096, 1350):
      args = _inputs(1, (5,), 8, width, members=2, device=cuda)
      leaves = _mlp_leaves(args, layout)
      pred = _mlp_call(fn, layout, 1, leaves, 'f32')
      grads = torch.autograd.grad(pred.sum(), leaves)
      assert all(bool(torch.isfinite(g).all()) for g in grads)
  with pytest.raises(ValueError, match='Unknown precision'):
    _mlp_call(fused_mlp.fused_field_mlp, 'rows', 1, leaves, 'fp16')


# K2 and K3 layer-wise, and K4a and K4b on the same kernels: (depth, width,
# rows, members, scratch budget in rows of the backward, or None). Width 100 is not a multiple of 8 (TMA's
# 16-byte strides); 333 and 129 rows are ragged in 128-row tiles; the budget
# case runs many chunks.
K2K3_SHAPES = [
    (2, 100, 333, 3, None), (2, 256, 200, 2, None), (2, 512, 130, 2, None),
    (2, 1024, 129, 2, None), (0, 1, 40, 3, None), (1, 512, 77, 2, None),
    (3, 100, 300, 2, None), (2, 64, 1000, 2, 128),
]
K2K3_IDS = ['width100', 'width256', 'width512', 'width1024', 'depth0',
            'depth1', 'depth3', 'chunks']


def _k2k3(monkeypatch, cuda, depth, width, n, members, budget_rows):
  """Inputs and cotangent of a K2 / K3 case; with `budget_rows` a scratch
  budget of about that many backward rows."""
  args = _inputs(depth, (3, 10, 6), n, width, members=members, device=cuda)
  g = torch.as_tensor(np.random.default_rng(1).normal(
      size=(members, n)).astype(np.float32), device=cuda)
  if budget_rows:
    monkeypatch.setattr(fused_mlp, 'TRAIN_SCRATCH_BYTES', budget_rows * 4 * (
        members * (19 + 3 * depth * width + 1)))
  return args, g


# Per layout: (forward, backward alone, their plain versions).
FIELD_MLP_FNS = {
    'features': (fused_mlp.fused_field_mlp_t, fused_mlp.fused_field_mlp_t_vjp,
                 fused_mlp.fused_field_mlp_t_reference,
                 fused_mlp.fused_field_mlp_t_vjp_reference),
    'rows': (fused_mlp.fused_field_mlp, fused_mlp.fused_field_mlp_vjp,
             fused_mlp.fused_field_mlp_reference,
             fused_mlp.fused_field_mlp_vjp_reference),
}


def _k2k3_outputs(depth, args, g, precision, kernel=True, layout='features'):
  """K2's prediction and K3's leaves (row-major: K4a's and K4b's), or their
  plain versions'."""
  fns = FIELD_MLP_FNS[layout]
  fwd, vjp = fns[:2] if kernel else fns[2:]
  h0 = (args['h0_groups'] if layout == 'features' else
        torch.cat(args['h0_groups'], 1).transpose(1, 2).contiguous())
  params = (args['weights'], args['biases'], args['scales_raw'],
            args['logit'])
  dh0, dws, dbs, dscales, dlogit = vjp(depth, h0, *params, g,
                                       precision=precision)
  dh0 = list(dh0) if layout == 'features' else [dh0]
  return [fwd(depth, h0, *params, precision=precision), *dh0, *dws, *dbs,
          dscales, dlogit]


def _check_k2k3(args, g, depth, precision, layout):
  """K2's prediction and K3's leaves (row-major K4a's and K4b's) against
  the plain versions ('bf16' against plain 'bf16', and within the JAX
  package's bf16 bound of plain fp32); two identical calls bit-equal; one
  launch of each kernel a call."""
  fn = FIELD_MLP_FNS[layout][0]
  before = (fn.launches, fn.bwd_launches)
  got = _k2k3_outputs(depth, args, g, precision, layout=layout)
  torch.cuda.synchronize()
  assert (fn.launches, fn.bwd_launches) == (before[0] + 1, before[1] + 1)
  want = _k2k3_outputs(depth, args, g, precision, kernel=False, layout=layout)
  if precision == 'f32':
    torch.testing.assert_close(got[0], want[0], **KERNEL_TOL)
  else:
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=2e-3)
    f32 = _k2k3_outputs(depth, args, g, 'f32', kernel=False, layout=layout)
    for k, f in zip(got, f32):
      off = (k - f).abs() - BF16_F32_TOL * f.abs()
      assert off.max().item() <= BF16_F32_TOL * f.abs().max().item()
  _assert_leaves_close(got[1:], want[1:], MLP_LEAF_TOL[precision])
  again = _k2k3_outputs(depth, args, g, precision, layout=layout)
  assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['features', 'rows'])
@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('depth,width,n,members,budget_rows', K2K3_SHAPES,
                         ids=K2K3_IDS)
def test_k2_k3_match_plain(cuda, monkeypatch, layout, precision, depth, width,
                           n, members, budget_rows):
  args, g = _k2k3(monkeypatch, cuda, depth, width, n, members, budget_rows)
  _check_k2k3(args, g, depth, precision, layout)


@pytest.mark.gpu
@pytest.mark.parametrize('depth,groups', [(2, (3, 10, 6)), (2, (1,)),
                                          (0, (1,))],
                         ids=['width1-depth2', 'one-feature',
                              'one-feature-depth0'])
def test_k4_bf16_keeps_one_column_products_fp32(cuda, depth, groups):
  # Row-major 'bf16' keeps fp32 every product whose result has one column:
  # at width 1 the hidden forwards and the W dv products of layers >= 1
  # (the first layer's, F = 19 outputs, still rounds, reading dv_0's twin
  # that the SIMT product of layer 1 writes); with F = 1 the first layer's
  # d h0. K4a and K4b against the plain 'bf16' version with those sites.
  width = 1 if groups[0] == 3 else 64
  args = _inputs(depth, groups, 300, width, members=2, device=cuda)
  g = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 300)).astype(
      np.float32), device=cuda)
  _check_k2k3(args, g, depth, 'bf16', 'rows')


@pytest.mark.gpu
@pytest.mark.parametrize('layout', ['features', 'rows'])
@pytest.mark.parametrize('depth,width,n,members,budget_rows',
                         [K2K3_SHAPES[0], K2K3_SHAPES[-1]],
                         ids=[K2K3_IDS[0], K2K3_IDS[-1]])
def test_k2_k3_highest_is_f32_bit_for_bit(cuda, monkeypatch, layout, depth,
                                          width, n, members, budget_rows):
  args, g = _k2k3(monkeypatch, cuda, depth, width, n, members, budget_rows)
  highest = _k2k3_outputs(depth, args, g, 'highest', layout=layout)
  f32 = _k2k3_outputs(depth, args, g, 'f32', layout=layout)
  assert all(torch.equal(a, b) for a, b in zip(highest, f32))
