"""Streamed fit and streamed predict at millions of rows, with their
footprints and bit-identity spot checks (counterpart of
`bayesnf_tpu/cli/stream_scale_run.py`).

It builds a synthetic hourly table of `--rows` rows as `np.memmap`s on disk,
block by block (`field.aug_features_host(out=...)`), so the table never
exists whole in process memory, as a table larger than the card's memory
would not. Then it records one JSON artifact with:

- the streamed MAP fit (`map.ensemble_map(stream_chunk_steps=...)`): wall
  seconds, member-steps/s and rows/s through the device;
- the streamed predict of three exact quantiles
  (`predict.predict_bnf(stream_chunk_rows=...)`): wall seconds and rows/s;
- footprints: the peak device memory of each
  (`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`), and
  the process's peak host RSS;
- unless `--skip-identity`: the fit's losses bit for bit the same for half
  the slice size, and the streamed predict bit for bit the in-memory one on
  4,096 sampled rows (the in-memory predict needs the grid on the device,
  which the default size allows).

The card's name and power limit (`nvidia-smi`) are in the artifact. Usage,
on a CUDA card:

    python -m bayesnf_torch.cli.stream_scale_run --json-out scale.json

`--rows` and `--ensemble` scale the run; `--device cpu` runs
it on the CPU (with `--width` small).
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import _build
from bayesnf_torch.utils import profiling

QUANTILES = (0.5, 0.025, 0.975)


def _peak_rss_gb():
  return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _card(device):
  """(device kind, power limit) of `device`: the card's name and
  nvidia-smi's power limit, or 'cpu' and None."""
  if device.type != 'cuda':
    return 'cpu', None
  return (torch.cuda.get_device_name(device),
          profiling.device_kind(device).split(',')[-1].strip())


class _DevicePeak:
  """Peak device bytes allocated inside a `with` block (None off CUDA)."""

  def __init__(self, device):
    self.device = device
    self.bytes = None

  def __enter__(self):
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
      torch.cuda.reset_peak_memory_stats(self.device)
    return self

  def __exit__(self, *exc):
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
      self.bytes = torch.cuda.max_memory_allocated(self.device)


def build_memmap_dataset(root, config, n_rows, seed=0, block=1_000_000):
  """(augmented rows, targets) as memmaps under `root`, written `block` rows
  at a time: hourly time, two standard-normal coordinates, and a target of
  a daily and a weekly cycle, the first coordinate and unit noise."""
  width = config.num_inputs + config.num_seasonal_features
  aug = np.memmap(os.path.join(root, 'aug.f32'), np.float32, 'w+',
                  shape=(n_rows, width))
  y = np.memmap(os.path.join(root, 'y.f32'), np.float32, 'w+',
                shape=(n_rows,))
  rng = np.random.default_rng(seed)
  for lo in range(0, n_rows, block):
    hi = min(lo + block, n_rows)
    t = np.arange(lo, hi, dtype=np.float32)
    space = rng.normal(size=(hi - lo, 2)).astype(np.float32)
    x = np.concatenate([t[:, None], space], axis=-1)
    y[lo:hi] = (10 * np.sin(2 * np.pi * t / 24.0)
                + 3 * np.sin(2 * np.pi * t / (24.0 * 7)) + space[:, 0]
                + rng.normal(size=hi - lo).astype(np.float32))
    field_lib.aug_features_host(config, x, out=aug[lo:hi])
  aug.flush()
  y.flush()
  return aug, y


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--json-out', required=True)
  parser.add_argument('--rows', type=int, default=5_000_000)
  parser.add_argument('--ensemble', type=int, default=8)
  parser.add_argument('--epochs', type=int, default=2)
  parser.add_argument('--batch-size', type=int, default=262_144)
  parser.add_argument('--stream-chunk-steps', type=int, default=4)
  parser.add_argument('--stream-chunk-rows', type=int, default=65_536)
  parser.add_argument('--skip-identity', action='store_true',
                      help='skip the in-memory cross-checks (a grid beyond '
                      'the device memory)')
  parser.add_argument('--workdir', default=None)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--width', type=int, default=512)
  args = parser.parse_args(argv)

  device = torch.device(args.device)
  n = int(args.rows)
  config = field_lib.FieldConfig.create(
      width=args.width, depth=2, input_scales=[float(n - 1), 1.0, 1.0],
      fourier_degrees=[5, 5, 5], interactions=[],
      seasonality_periods=[24.0, 24.0 * 7], num_seasonal_harmonics=[4, 4])
  backend = 'kernel' if device.type == 'cuda' else 'torch'
  if device.type == 'cuda':
    for name in ('fused_train', 'fused_mlp_t'):
      _build.build(name)  # Outside the timed runs.
  device_kind, power_limit = _card(device)

  with tempfile.TemporaryDirectory(dir=args.workdir) as workdir:
    start = time.perf_counter()
    aug, y = build_memmap_dataset(workdir, config, n)
    build_s = time.perf_counter() - start

    def run_fit(stream_chunk_steps):
      # Streamed whatever the size: the table stays on the host.
      return map_lib.ensemble_map(
          aug, y, config, likelihoods.LikelihoodDist.NORMAL,
          ensemble_size=args.ensemble, learning_rate=0.005,
          num_epochs=args.epochs, seed=0, batch_size=args.batch_size,
          prior_weight=1.0, backend=backend, device=device,
          stream_chunk_steps=stream_chunk_steps)

    with _DevicePeak(device) as fit_peak:
      start = time.perf_counter()
      params, stream_losses = run_fit(args.stream_chunk_steps)
      fit_s = time.perf_counter() - start
    if not np.isfinite(stream_losses).all():
      raise RuntimeError('The streamed fit gave a non-finite loss.')
    steps = args.epochs * (n // args.batch_size)
    artifact = {
        'command': ' '.join(['python -m bayesnf_torch.cli.stream_scale_run',
                             *(sys.argv[1:] if argv is None else argv)]),
        'device_kind': device_kind,
        'power_limit': power_limit,
        'backend': backend,
        'rows': n,
        'ensemble': args.ensemble,
        'width': args.width,
        'host_dataset_gb': (aug.nbytes + y.nbytes) / 2**30,
        'dataset_build_s': build_s,
        'streamed_fit': {
            'epochs': args.epochs,
            'batch_size': args.batch_size,
            'stream_chunk_steps': args.stream_chunk_steps,
            'wall_s': fit_s,
            'member_steps_per_sec': steps * args.ensemble / fit_s,
            'rows_per_sec_through_device': steps * args.batch_size / fit_s,
            'peak_device_bytes': fit_peak.bytes,
        },
        'peak_host_rss_gb_after_fit': _peak_rss_gb(),
    }

    # The public (1, E, ...) layout; the raw features are the memmap's
    # first columns, a view.
    p_pub = tuple(p[None] for p in params)
    x_mm = aug[:, :config.num_inputs]
    with _DevicePeak(device) as predict_peak:
      start = time.perf_counter()
      means_s, qs_s = predict_lib.predict_bnf(
          x_mm, 'NORMAL', p_pub, config, quantiles=QUANTILES,
          ensemble_dims=2, backend=backend,
          stream_chunk_rows=args.stream_chunk_rows)
      predict_s = time.perf_counter() - start
    if not all(bool(torch.isfinite(t).all()) for t in (means_s, *qs_s)):
      raise RuntimeError('The streamed predict gave a non-finite value.')
    # Host chunks are whole 4,096-row device chunks.
    chunk_rows = min(-(-args.stream_chunk_rows // 4096), -(-n // 4096)) * 4096
    chunks = -(-n // chunk_rows)
    artifact['streamed_predict'] = {
        'stream_chunk_rows': args.stream_chunk_rows,
        'chunks': chunks,
        'wall_s': predict_s,
        'rows_per_sec': n / predict_s,
        'quantiles': len(QUANTILES),
        'peak_device_bytes': predict_peak.bytes,
    }
    artifact['peak_host_rss_gb_after_predict'] = _peak_rss_gb()

    if not args.skip_identity:
      # The fit: slices are only the copies' granularity, so half the slice
      # gives the same batches and losses. The predict: the in-memory one
      # on the same parameters, at 4,096 sampled rows.
      _, other = run_fit(max(1, args.stream_chunk_steps // 2))
      artifact['fit_losses_bit_invariant_to_slice_size'] = bool(
          np.array_equal(stream_losses, other))
      means_m, qs_m = predict_lib.predict_bnf(
          np.asarray(x_mm), 'NORMAL', p_pub, config, quantiles=QUANTILES,
          ensemble_dims=2, backend=backend)
      idx = np.sort(np.random.default_rng(0).choice(
          n, size=min(n, 4096), replace=False))
      idx_t = torch.as_tensor(idx)
      artifact['predict_bit_identical_on_4096_sampled_rows'] = bool(
          torch.equal(means_s[..., idx_t], means_m[..., idx_t].cpu())
          and all(torch.equal(s[idx_t], m[idx_t].cpu())
                  for s, m in zip(qs_s, qs_m)))
      del means_m, qs_m
    del aug, y, x_mm

  with open(args.json_out, 'w') as f:
    json.dump(artifact, f, indent=2)
    f.write('\n')
  print(json.dumps(artifact, indent=2))
  failed = [key for key in ('fit_losses_bit_invariant_to_slice_size',
                            'predict_bit_identical_on_4096_sampled_rows')
            if artifact.get(key) is False]
  if failed:
    raise RuntimeError(f'Identity checks failed: {failed}.')
  return artifact


if __name__ == '__main__':
  main()
