#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit (nvcc). It imports nothing of JAX. Phases, one line each:

1. Refuse to run without CUDA; print the card's name and power limit.
2. Build the K2 kernel (`bayesnf_torch/ops/csrc/fused_mlp_fwd.cu`) with nvcc
   from the checkout's sources.
3. Hold the kernel against its plain PyTorch version on the card, at the
   main path's shapes (64 members, 49 features, 4096 rows, width 512, depth
   2) and at a ragged row count, widths 256 and 1024 and depths 1 and 3;
   time both with CUDA events.
4. Golden check: the committed artifact fitted by the JAX package, loaded
   onto the card, must predict what the JAX package predicted (the
   tolerances of `tests/test_torch_predict.py`).
5. The main path at full width: an hourly table of 38,096 rows, a width-512
   depth-2 MAP estimator with 64 members drawn by `init_params` from
   `--seed`, saved, loaded onto the card and asked for means and three
   quantiles three times through the kernel and once through plain PyTorch.
6. A JSON line of the kernels, then the last line,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed check raises, and the script exits non-zero with no result.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pandas as pd
import torch

import bayesnf_torch
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.ops import _build
from bayesnf_torch.ops import fused_mlp

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, 'tests', 'test_data',
                      'bnf-map.chickenpox.8.port.npz')
GOLDEN_PRED = os.path.join(REPO, 'tests', 'test_data',
                           'bnf-map.chickenpox.8.port-pred.npz')
GOLDEN_TABLE = os.path.join(REPO, 'tests', 'test_data',
                            'chickenpox.8.train.csv')
QUANTILES = (0.5, 0.025, 0.975)
# Kernel against plain version: fp32 sums over fan-in <= 1024 taken in
# another order than torch.matmul's.
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# Means against the JAX package (as in tests/test_torch_predict.py).
MEANS_TOL = dict(rtol=2e-5, atol=1e-4)
# Quantile roots: rtol 2e-5 plus 1e-4 of the largest member noise scale
# (two searches may stop at different points inside the 1e-5 CDF tolerance).
QUANTILE_SCALE_TOL = 1e-4
N_ROWS = 38_096
MEMBERS = 64
CHUNK = 4096


def phase(name, **fields):
  print(f'phase {name}: ' + ', '.join(f'{k}={v}' for k, v in fields.items()),
        flush=True)


def cuda_ms(fn, reps=10):
  """Mean device milliseconds of `fn` over `reps` launches, after a warm-up."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def kernel_inputs(members, groups, n, width, depth, seed):
  """Random K2 inputs on the card, scaled like an encoded, initialized model."""
  rng = np.random.default_rng(seed)
  fan_ins = [sum(groups)] + [width] * depth
  fan_outs = [width] * depth + [1]

  def cuda(a):
    return torch.from_numpy(a.astype(np.float32)).cuda()

  return dict(
      h0_groups=[cuda(rng.uniform(-1, 1, (members, g, n))) for g in groups],
      weights=[cuda(np.clip(rng.normal(size=(members, fi, fo)), -2, 2))
               for fi, fo in zip(fan_ins, fan_outs)],
      biases=[cuda(rng.normal(scale=0.3, size=(members, fo)))
              for fo in fan_outs],
      scales_raw=cuda(rng.normal(scale=0.5, size=(members, depth + 1))),
      logit=cuda(rng.normal(size=(members,))),
  )


def check_kernel(seed):
  """Phase 3; returns (max abs error, kernel ms, plain ms) at the main shape."""
  main_groups = (3, 10, 10, 10, 16)  # x, 3 Fourier inputs, seasonal: F = 49.
  cases = [
      ('main', main_groups, CHUNK, 512, 2),
      ('ragged', main_groups, CHUNK - 3, 512, 2),
      ('width256', main_groups, CHUNK - 3, 256, 2),
      ('width1024', main_groups, CHUNK - 3, 1024, 2),
      ('depth1', main_groups, 1000, 512, 1),
      ('depth3', main_groups, 1001, 512, 3),
  ]
  worst, timing = 0.0, None
  for name, groups, n, width, depth in cases:
    args = kernel_inputs(MEMBERS, groups, n, width, depth, seed)
    got = fused_mlp.fused_field_mlp_t(depth, **args)
    torch.cuda.synchronize()
    want = fused_mlp.fused_field_mlp_t_reference(depth, **args)
    err = (got - want).abs()
    # Relative to max(|want|, 1e-3).
    rel = (err / want.abs().clamp(min=1e-3)).max().item()
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    ms = cuda_ms(lambda: fused_mlp.fused_field_mlp_t(depth, **args))
    plain_ms = cuda_ms(
        lambda: fused_mlp.fused_field_mlp_t_reference(depth, **args))
    worst = max(worst, err.max().item())
    phase('3 kernel-vs-plain', case=name, members=MEMBERS, rows=n,
          width=width, depth=depth,
          tile_rows=fused_mlp.pick_tile_rows(sum(groups), width),
          max_abs_err=f'{err.max().item():.3e}',
          max_rel_err=f'{rel:.3e}',
          kernel_ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}')
    if name == 'main':
      timing = (ms, plain_ms)
  return worst, timing[0], timing[1]


def quantile_atol(params):
  return QUANTILE_SCALE_TOL * (0.01 + math.exp(params[0].max().item()))


def check_golden():
  """Phase 4: the JAX package's artifact and predictions, on the card."""
  model = bayesnf_torch.BayesianNeuralFieldEstimator.load(GOLDEN,
                                                          device='cuda')
  table = pd.read_csv(GOLDEN_TABLE, index_col=0, parse_dates=['datetime'])
  before = fused_mlp.fused_field_mlp_t.launches
  means, quantiles = model.predict(table, quantiles=QUANTILES)
  assert fused_mlp.fused_field_mlp_t.launches == before + 1
  with np.load(GOLDEN_PRED) as ref:
    np.testing.assert_allclose(means.cpu().numpy(), ref['means'], **MEANS_TOL)
    atol = quantile_atol(model.params_)
    q_err = []
    for got, want in zip(quantiles, ref['quantiles']):
      np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-5,
                                 atol=atol)
      q_err.append(np.abs(got.cpu().numpy() - want).max())
    m_err = np.abs(means.cpu().numpy() - ref['means']).max()
  phase('4 golden', artifact=os.path.relpath(GOLDEN, REPO),
        means_shape=tuple(means.shape), means_max_abs_err=f'{m_err:.3e}',
        quantile_max_abs_err=f'{max(q_err):.3e}',
        quantile_atol=f'{atol:.3e}')


def bench_table(seed):
  """An hourly table shaped like bench.py's workload: time and 2 coords."""
  rng = np.random.default_rng(seed)
  t = np.arange(N_ROWS)
  space = rng.normal(size=(N_ROWS, 2))
  y = (10 * np.sin(2 * np.pi * t / 24.0)
       + 3 * np.sin(2 * np.pi * t / (24.0 * 7))
       + space[:, 0] + rng.normal(size=N_ROWS))
  return pd.DataFrame({
      'datetime': pd.Timestamp('2021-01-01') + pd.to_timedelta(t, unit='h'),
      'lat': space[:, 0], 'lon': space[:, 1], 'y': y,
  })


def mixture_cdf_residual(x, means, scales, q):
  """max |mean_members Phi((x - mu) / sigma) - q|, in float64."""
  z = (x.double() - means.double()) / scales.double()[..., None]
  return (torch.special.ndtr(z).mean(dim=(0, 1)) - q).abs().max().item()


def check_main_path(seed):
  """Phase 5; returns the kernel launches counted while it drove the path."""
  table = bench_table(seed)
  est = bayesnf_torch.BayesianNeuralFieldMAP(
      feature_cols=['datetime', 'lat', 'lon'], target_col='y', width=512,
      depth=2, timetype='index', freq='h', seasonality_periods=[24, 168],
      num_seasonal_harmonics=[4, 4], fourier_degrees=[5, 5, 5],
      standardize=['lat', 'lon'])
  train = est.data_handler.get_train(table)
  config = est._field_config(train.shape)  # pylint: disable=protected-access
  assert config.encoded_dim == 49, config.encoded_dim
  generator = torch.Generator(device='cuda').manual_seed(seed)
  log_noise = math.log(float(np.std(table['y'])) / 2)
  members = [field_lib.init_params(config, generator, 'cuda', log_noise)
             for _ in range(MEMBERS)]
  est.params_ = tuple(
      torch.stack(leaves).reshape((1, MEMBERS) + tuple(leaves[0].shape))
      for leaves in zip(*members))

  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'estimator.npz')
    est.save(path)
    served = bayesnf_torch.BayesianNeuralFieldEstimator.load(path,
                                                             device='cuda')

  chunks = -(-len(table) // CHUNK)
  calls = 3
  torch.cuda.synchronize()
  fused_mlp.fused_field_mlp_t.launches = 0
  kernel_ms = []
  for _ in range(calls):
    start = time.perf_counter()
    means, quantiles = served.predict(table, quantiles=QUANTILES)
    torch.cuda.synchronize()
    kernel_ms.append((time.perf_counter() - start) * 1e3)
  launches = fused_mlp.fused_field_mlp_t.launches
  assert launches == chunks * calls, (launches, chunks * calls)

  assert tuple(means.shape) == (1, MEMBERS, len(table)), means.shape
  assert all(tuple(q.shape) == (len(table),) for q in quantiles)
  assert bool(torch.isfinite(means).all())
  assert all(bool(torch.isfinite(q).all()) for q in quantiles)

  start = time.perf_counter()
  t_means, t_quantiles = served.predict(table, quantiles=QUANTILES,
                                        backend='torch')
  torch.cuda.synchronize()
  torch_ms = (time.perf_counter() - start) * 1e3
  assert fused_mlp.fused_field_mlp_t.launches == launches
  torch.testing.assert_close(means, t_means, **KERNEL_TOL)
  scales = 0.01 + torch.exp(served.params_[0])
  residuals = []
  for q, got, want in zip(QUANTILES, quantiles, t_quantiles):
    # Each root meets the search's 1e-5 value tolerance on the other
    # backend's means too; positions agree to 1e-3 of the noise scale.
    residuals.append(mixture_cdf_residual(got, t_means, scales, q))
    assert residuals[-1] <= 2e-5, (q, residuals[-1])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * scales.max().item())
  phase('5 main-path', rows=len(table), members=MEMBERS, width=512, depth=2,
        encoded_dim=config.encoded_dim, kernel_launches=launches,
        expected_launches=chunks * calls,
        predict_ms_kernel='/'.join(f'{t:.2f}' for t in kernel_ms),
        predict_ms_torch=f'{torch_ms:.2f}',
        means_max_abs_diff=f'{(means - t_means).abs().max().item():.3e}',
        quantile_cdf_residual_max=f'{max(residuals):.3e}')
  return launches


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args(argv)

  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available; this smoke runs on a GPU.',
          file=sys.stderr)
    return 1
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip().splitlines()
  print(card[0], flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  kind = torch.cuda.get_device_name(0)
  phase('1 device', kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

  path, seconds, report = _build.build('fused_mlp_fwd')
  ptxas = [line.split(':', 1)[-1].strip() for line in report.splitlines()
           if 'registers' in line or 'spill' in line]
  phase('2 build', library=os.path.relpath(path, REPO),
        seconds=f'{seconds:.2f}', arch='sm_90a', ptxas=' | '.join(ptxas))

  max_err, ms, plain_ms = check_kernel(args.seed)
  check_golden()
  launches = check_main_path(args.seed)

  print(json.dumps({'kernels': [{
      'name': 'fused_field_mlp_t',
      'route': 'cuda',
      'source': 'bayesnf_torch/ops/csrc/fused_mlp_fwd.cu',
      'replaces': 'bayesnf_tpu/ops/fused_mlp.py:488',
      'launches': launches,
      'max_abs_err': max_err,
      'ms': ms,
      'plain_ms': plain_ms,
  }]}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
