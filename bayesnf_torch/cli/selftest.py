"""Hardware self-test: CUDA kernel / plain PyTorch backend agreement on the
card (counterpart of `bayesnf_tpu/cli/selftest.py`).

Qualification tool for a new card or toolchain: runs the REAL production
paths (`inference.map.fit_map`, `inference.vi.fit_vi`,
`inference.predict.predict_bnf` and `forecast_params_bnf`) twice — the
hand-written CUDA kernels ('kernel': K1 for every fit step, K2 for every
predict chunk) against their plain PyTorch versions ('torch') — on a small
synthetic spatiotemporal workload, and asserts the two agree within kernel
tolerances for every observation model. The checks, their names, order and
tolerances are the JAX tool's.

Usage, on a CUDA card:

    python -m bayesnf_torch.cli.selftest
    python -m bayesnf_torch.cli.selftest --epochs 50 --rows 1024

Prints one line per check and a final JSON summary; exit code is non-zero
on any disagreement. 'kernel' runs only on CUDA and has no CPU stand-in
(the JAX tool runs its Pallas kernels in interpret mode there): with a
device that is not a CUDA card the tool says so and exits non-zero before
any fit. Seeds are ints (the JAX tool's `PRNGKey(7)` is `7`).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.inference import vi as vi_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.utils import profiling

# The (reference, under test) backend pair: the JAX tool's ('xla', 'pallas').
# The CPU tests set it to ('torch', 'torch') to run the flow without a card.
BACKENDS = ('torch', 'kernel')
SEED = 7


def _workload(rows, width, seed=0):
  """Small but representative config + synthetic data (counts included):
  (config, aug features as a CPU tensor, NORMAL and count targets as
  numpy)."""
  config = field_lib.FieldConfig.create(
      width=width,
      depth=2,
      input_scales=[168.0, 1.0, 1.0],
      fourier_degrees=[5, 3, 3],
      interactions=[(0, 1), (1, 2)],
      seasonality_periods=[24.0, 24.0 * 7],
      num_seasonal_harmonics=[3, 2],
  )
  rng = np.random.default_rng(seed)
  t = np.arange(rows, dtype=np.float32) % 720.0
  space = rng.normal(size=(rows, 2)).astype(np.float32)
  x = np.concatenate([t[:, None], space], axis=-1)
  rate = np.exp(
      1.0
      + 0.8 * np.sin(2 * np.pi * t / 24.0)
      + 0.3 * space[:, 0]
  )
  y_counts = rng.poisson(rate).astype(np.float32)
  y_counts[:: 11] = 0.0  # exercise the ZINB zero branch
  y_normal = (rate + rng.normal(scale=0.5, size=rows)).astype(np.float32)

  aug = field_lib.aug_features(config, torch.from_numpy(x))
  return config, aug, y_normal, y_counts


def _host(values):
  """Tensors (on any device) as CPU tensors, which numpy reads."""
  return tuple(v.cpu() for v in values)


def _loss_agreement(name, losses_a, losses_b, rtol, checks):
  a = np.asarray(losses_a, dtype=np.float64)
  b = np.asarray(losses_b, dtype=np.float64)
  # Per-member final losses: the kernel-vs-plain tolerance contract.
  # Pure relative error is well-conditioned here: losses are O(1e2) and
  # bounded away from zero. Predictions are NOT (they cross zero) — those
  # go through `_pred_agreement` instead.
  rel = np.max(np.abs(a - b) / (np.abs(b) + 1e-6))
  ok = bool(rel < rtol)
  checks.append({'check': name, 'max_rel': float(rel), 'tol': rtol, 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: max_rel={rel:.2e} (tol {rtol})')
  return ok


def _pred_agreement(name, pred_a, pred_b, rtol, data_scale, checks):
  """Scale-aware agreement for signed predictions.

  Pure relative error |a-b|/|b| is ill-conditioned where predictions cross
  zero (a 5e-4 absolute difference near b=0 reads as 'rel=0.2'). Contract:
  |a - b| <= atol + rtol * max(|a|, |b|) elementwise, with atol tied to the
  scale of the *data* (rtol * std(y)) rather than of the predictions — a
  barely-trained model predicts near zero, and the f32 kernel-vs-plain
  forward-pass floor (~1e-4 absolute at these magnitudes) is hardware
  agreement, not divergence, whenever it is tiny against the observable
  signal.
  """
  a = np.asarray(pred_a, dtype=np.float64)
  b = np.asarray(pred_b, dtype=np.float64)
  atol = rtol * max(float(data_scale), 1e-12)
  err = np.max(np.abs(a - b) / (atol + rtol * np.maximum(np.abs(a), np.abs(b))))
  ok = bool(err <= 1.0)
  checks.append({'check': name, 'scaled_err': float(err), 'atol': atol,
                 'rtol': rtol, 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: scaled_err={err:.2e} '
        f'(tol: |a-b| <= {atol:.2e} + {rtol}*max|a|,|b|)')
  return ok


def _count_quantile_agreement(name, q_a, q_b, checks):
  """Integer quantiles sit on a discretization cliff: the root-find's ceil
  flips a whole count when the two backends' CDFs differ in the last few
  ulps at an integer boundary. Agreement contract: every row within one
  count, and at most max(1, 1% of rows) rows differ at all (the floor of
  one keeps the bound meaningful at small --rows, where a single flip
  exceeds 1%)."""
  a = np.asarray(q_a, dtype=np.float64)
  b = np.asarray(q_b, dtype=np.float64)
  max_abs = float(np.max(np.abs(a - b))) if a.size else 0.0
  mismatches = int(np.sum(a != b))
  allowed = max(1, int(np.ceil(0.01 * a.size)))
  ok = bool(max_abs <= 1.0 and mismatches <= allowed)
  checks.append({'check': name, 'max_abs_counts': max_abs,
                 'mismatches': mismatches, 'allowed_mismatches': allowed,
                 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: max_abs={max_abs:.0f} counts, '
        f'mismatches={mismatches}/{a.size} '
        f'(tol: <=1 count, <={allowed} rows)')
  return ok


def stream_batch_size(rows):
  """The streamed fits' batch: a quarter of the rows (at least 32), capped
  at rows // 2, since streaming requires a true minibatch (batch < rows)
  and small --rows invocations must stay legal."""
  return max(1, min(max(32, rows // 4), rows // 2))


def _cuda_missing(device):
  """Why the 'kernel' backend cannot run on `device`, or None if it can."""
  if torch.device(device).type != 'cuda':
    return f'device {device!r} is not a CUDA card'
  if not torch.cuda.is_available():
    return 'CUDA is not available'
  return None


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--rows', type=int, default=512)
  parser.add_argument('--width', type=int, default=64)
  parser.add_argument('--epochs', type=int, default=30)
  parser.add_argument('--ensemble', type=int, default=4)
  parser.add_argument('--rtol', type=float, default=5e-3,
                      help='relative tolerance on final per-member losses')
  parser.add_argument('--json-out', type=str, default=None,
                      help='also write the full JSON summary (per-check '
                           'detail, device, args) to this path')
  parser.add_argument('--device', default='cuda',
                      help="where the fits and predicts run; 'kernel' "
                           'needs a CUDA card')
  args = parser.parse_args(argv)

  device = torch.device(args.device)
  if 'kernel' in BACKENDS:
    missing = _cuda_missing(args.device)
    if missing is not None:
      print(f"selftest: backend 'kernel' runs the CUDA kernels and needs a "
            f'CUDA card: {missing}.', file=sys.stderr)
      return 2
  backend = device.type
  kind = profiling.device_kind(device)
  print(f'device backend: {backend} ({kind})')
  reference, tested = BACKENDS
  config, aug, y_normal, y_counts = _workload(args.rows, args.width)
  features = aug[:, : config.num_inputs]

  checks = []
  t0 = time.perf_counter()
  for distribution in ('NORMAL', 'NB', 'ZINB'):
    y = y_normal if distribution == 'NORMAL' else y_counts
    results = {}
    for train_backend in BACKENDS:
      params, losses = map_lib.fit_map(
          aug, y,
          seed=SEED,
          observation_model=distribution,
          config=config,
          num_particles=args.ensemble,
          learning_rate=0.005,
          num_epochs=args.epochs,
          backend=train_backend,
          device=device,
      )
      results[train_backend] = (params, losses[:, -1])
    _loss_agreement(
        f'map/{distribution} final losses',
        results[tested][1], results[reference][1], args.rtol, checks,
    )

    # Predict agreement on the params the reference fit produced (shared
    # input to both predicts; count models exercise the root-finder).
    p = tuple(x.unsqueeze(0) for x in results[reference][0])  # (1, E, ...)
    if distribution == 'NORMAL':
      normal_params = results[reference][0]  # for the streamed-predict leg
    preds = {}
    for predict_backend in BACKENDS:
      means, (q50, q975) = predict_lib.predict_bnf(
          features,
          distribution,
          p,
          config,
          quantiles=(0.5, 0.975),
          ensemble_dims=2,
          backend=predict_backend,
      )
      preds[predict_backend] = _host((means, q50, q975))
    count_model = distribution != 'NORMAL'
    for i, part in enumerate(('means', 'q50', 'q975')):
      name = f'predict/{distribution} {part}'
      if count_model and part != 'means':
        _count_quantile_agreement(
            name, preds[tested][i], preds[reference][i], checks)
      else:
        _pred_agreement(
            name, preds[tested][i], preds[reference][i], args.rtol,
            np.std(y), checks)

  # VI: ELBO trajectory agreement (NORMAL is the representative cell; the
  # per-distribution kernel bodies are already covered by the MAP loop).
  vi_losses = {}
  vi_draws = {}
  for train_backend in BACKENDS:
    _, losses, draws = vi_lib.fit_vi(
        aug, y_normal,
        seed=SEED,
        observation_model='NORMAL',
        config=config,
        ensemble_size=args.ensemble,
        learning_rate=0.01,
        num_epochs=args.epochs,
        sample_size_divergence=3,
        sample_size_posterior=4,
        kl_weight=0.1,
        backend=train_backend,
        device=device,
    )
    vi_losses[train_backend] = losses[:, -1]
    vi_draws[train_backend] = draws
  _loss_agreement(
      'vi/NORMAL final losses',
      vi_losses[tested], vi_losses[reference], args.rtol, checks,
  )

  # VI predict: the ensemble_dims=3 path (groups x surrogates x draws) —
  # means + an exact mixture quantile over the posterior-draw ensemble,
  # backend agreement on the reference fit's draws.
  vi_p = tuple(d.unsqueeze(0) for d in vi_draws[reference])  # (1, E, S, ...)
  vi_preds = {}
  for predict_backend in BACKENDS:
    means, (q50,) = predict_lib.predict_bnf(
        features, 'NORMAL', vi_p, config,
        quantiles=(0.5,), ensemble_dims=3, backend=predict_backend,
    )
    vi_preds[predict_backend] = _host((means, q50))
  for i, part in enumerate(('means', 'q50')):
    _pred_agreement(
        f'vi-predict/NORMAL {part}',
        vi_preds[tested][i], vi_preds[reference][i], args.rtol,
        np.std(y_normal), checks)

  # likelihood_model's engine: raw forecast distribution parameters
  # (total_count/logits/pi) must agree across backends — this is the path
  # `estimator.likelihood_model` serves distributions from.
  p_zinb = tuple(x.unsqueeze(0) for x in results[reference][0])  # last fit
  fp_by_backend = {}
  for predict_backend in BACKENDS:
    fp_by_backend[predict_backend] = _host(predict_lib.forecast_params_bnf(
        features, 'ZINB', p_zinb, config,
        ensemble_dims=2, backend=predict_backend,
    ))
  for i, part in enumerate(('total_count', 'logits', 'pi')):
    _pred_agreement(
        f'likelihood-model/ZINB {part}',
        fp_by_backend[tested][i], fp_by_backend[reference][i], args.rtol,
        float(np.std(np.asarray(fp_by_backend[reference][i]))) or 1.0,
        checks)

  # Streaming: host-resident dataset shipped to the device in step slices.
  # Two on-device contracts: (a) backend agreement on a streamed minibatch
  # fit; (b) slice-size bit-invariance — the slice size is pure transfer
  # granularity and must not change the math.
  aug_host = aug.numpy()
  stream_batch = stream_batch_size(args.rows)
  stream_kwargs = dict(
      seed=SEED, config=config, num_particles=args.ensemble,
      learning_rate=0.005, num_epochs=args.epochs, batch_size=stream_batch,
      device=device)
  stream_losses = {}
  for train_backend in BACKENDS:
    _, losses = map_lib.fit_map(
        aug_host, y_normal, observation_model='NORMAL',
        backend=train_backend, stream_chunk_steps=2, **stream_kwargs)
    stream_losses[train_backend] = losses
  _loss_agreement(
      'stream/NORMAL final losses',
      stream_losses[tested][:, -1], stream_losses[reference][:, -1],
      args.rtol, checks,
  )
  _, losses_s3 = map_lib.fit_map(
      aug_host, y_normal, observation_model='NORMAL', backend=tested,
      stream_chunk_steps=3, **stream_kwargs)
  bit_ok = bool(np.array_equal(stream_losses[tested], losses_s3))
  checks.append({'check': 'stream/NORMAL slice bit-invariance',
                 'bitwise_equal': bit_ok, 'ok': bit_ok})
  print(f'{"PASS" if bit_ok else "FAIL"} stream/NORMAL slice '
        f'bit-invariance: chunk_steps 2 vs 3 '
        f'{"bitwise equal" if bit_ok else "DIFFER"}')

  # Count-model streaming: the kernel's Stirling gammaln path under the
  # streamed slice program, backend agreement.
  nb_stream_losses = {}
  for train_backend in BACKENDS:
    _, losses = map_lib.fit_map(
        aug_host, y_counts, observation_model='NB', backend=train_backend,
        stream_chunk_steps=2, **stream_kwargs)
    nb_stream_losses[train_backend] = losses
  _loss_agreement(
      'stream/NB final losses',
      nb_stream_losses[tested][:, -1], nb_stream_losses[reference][:, -1],
      args.rtol, checks,
  )

  # VI streaming: per-step host-resampled batches through the fused
  # kernel; backend agreement on the final ELBO.
  vi_stream_losses = {}
  for train_backend in BACKENDS:
    _, losses, _ = vi_lib.fit_vi(
        aug_host, y_normal,
        seed=SEED,
        observation_model='NORMAL',
        config=config,
        ensemble_size=args.ensemble,
        learning_rate=0.01,
        num_epochs=args.epochs,
        sample_size_divergence=3,
        sample_size_posterior=2,
        kl_weight=0.1,
        batch_size=stream_batch,
        backend=train_backend,
        device=device,
        stream_chunk_steps=2,
    )
    vi_stream_losses[train_backend] = losses[:, -1]
  _loss_agreement(
      'stream-vi/NORMAL final losses',
      vi_stream_losses[tested], vi_stream_losses[reference], args.rtol,
      checks,
  )

  # Out-of-core streamed predict: host-chunked rows with the global-
  # bracket two-pass scheme must reproduce the in-memory predict on the
  # device (same backend: bit for bit in the port; the tolerance is the
  # JAX tool's).
  p_norm = tuple(x.unsqueeze(0) for x in normal_params)
  sp_kwargs = dict(quantiles=(0.5, 0.975), ensemble_dims=2, backend=tested)
  mem = predict_lib.predict_bnf(features, 'NORMAL', p_norm, config,
                                **sp_kwargs)
  streamed = predict_lib.predict_bnf(
      features.numpy(), 'NORMAL', p_norm, config,
      stream_chunk_rows=max(64, args.rows // 3), **sp_kwargs
  )
  _pred_agreement(
      'stream-predict/NORMAL means', streamed[0], mem[0].cpu(), args.rtol,
      np.std(y_normal), checks)
  for qi, part in enumerate(('q50', 'q975')):
    _pred_agreement(
        f'stream-predict/NORMAL {part}', streamed[1][qi], mem[1][qi].cpu(),
        args.rtol, np.std(y_normal), checks)

  ok = all(c['ok'] for c in checks)
  summary = {
      'backend': backend,
      'ok': ok,
      'num_checks': len(checks),
      'wall_s': round(time.perf_counter() - t0, 1),
      'failed': [c['check'] for c in checks if not c['ok']],
  }
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(
          {
              **summary,
              'device_kind': kind,
              'num_devices': profiling.num_devices(device),
              'args': {
                  'rows': args.rows, 'width': args.width,
                  'epochs': args.epochs, 'ensemble': args.ensemble,
                  'rtol': args.rtol,
              },
              'checks': checks,
          },
          f,
          indent=2,
      )
      f.write('\n')
  print(json.dumps(summary))
  return 0 if ok else 1


if __name__ == '__main__':
  sys.exit(main())
