#!/usr/bin/env python3
"""The PyTorch port's bench leg: fit throughput and predict latency on one
CUDA card.

    python3 bench_torch.py [--cells main,widths,sst,nb,vi] [--repeats 5]
                           [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA card and nvcc
(the 'kernel' backend builds the port's CUDA kernels at first use). It
refuses to run without CUDA. It prints the card's `name, power.limit` and
then one JSON line per leg (a cell on one backend and precision):

- `member_steps_per_s`: members x Adam steps over the host seconds around
  `timed_epochs` synchronized epochs, started from the parameters of one
  warm-up fit (1 epoch), `--repeats` times (at least 5 by default): median,
  min, max, `spread` = (max - min) / median, and every run;
- `predict_ms`: `predict(table, quantiles=(0.5, 0.025, 0.975))` over the
  whole table, host clock from the call to a `synchronize()` after it
  (pandas included), 10 calls: p50, p90, min, max and every call;
- the leg's backend, precision, width, rows, members, batch size, and the
  card's name and power limit.

On 'kernel' every timed step must launch K1 once and every predict K2 once
per 4,096-row chunk (the launch counters of `ops/fused_mlp.py`); on 'torch'
neither. Losses, means and quantiles must be finite and the quantiles
ordered. A leg that fails raises, and the script exits non-zero.

Cells (tables synthetic, made from `--seed` with numpy; each on 'kernel'
and 'torch' unless marked):

- main: bench.py:111-158's workload, the registry's `air_quality` MAP model
  (38,096 hourly rows, inputs (t, two coordinates), Fourier degree 5,
  seasonal periods 24 and 168 with 4 harmonics, width 512, depth 2), 64
  members, full batch, lr 0.005; at 'f32' and 'bf16'.
- widths: main at widths 256, 768 and 1024; 'f32', 'kernel' only.
- sst: a table of sst's full-batch shape at its published stanza
  (`cli/registry.py`: 221,127 monthly rows, inputs (t, lat, lon, soi),
  width 768, seasonal period 12 with 6 harmonics, 16 members, full batch);
  at 'f32' and 'bf16'.
- nb: main's table with targets poisson(exp(y / 8) + 1) (bench.py:233-268)
  and the NB likelihood.
- vi: the `air_quality` VI stanza (16 members, batch 3,500, 5 draws per
  ELBO, kl_weight 0.2, lr 0.01; 10 steps an epoch) on main's table; its
  predict covers 30 posterior draws per member (480 members).

Cuts, to keep the leg near 15 minutes on an H100: timed epochs per repeat
10 (bench.py times 200 MAP and 100 NB epochs), sst 3 (its stanza trains
5,000), vi 3 epochs = 30 steps (its stanza trains 500 epochs); the
warm-up fit trains 1 epoch; predicts run on the warm-up fit's parameters.
"""

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import torch

import bayesnf_torch
from bayesnf_torch.cli import registry
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import vi as vi_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.ops import fused_mlp

QUANTILES = (0.5, 0.025, 0.975)
PREDICT_CALLS = 10
PREDICT_CHUNK = 4096  # Rows per K2 call (`inference/predict.py`).
DEFAULT_REPEATS = 5
HOURLY_ROWS = 38_096
SST_ROWS = 221_127
SST_LOCATIONS = 1_317  # x 168 months covers SST_ROWS.


@dataclasses.dataclass(frozen=True)
class Leg:
  """One cell on one backend and precision."""

  cell: str
  backend: str
  precision: str = 'f32'
  dataset: str = 'air_quality'  # The registry stanza of the model.
  objective: str = 'map'  # 'map' | 'vi'
  likelihood: str = 'NORMAL'
  width: int | None = None  # None: the stanza's.
  rows: int = HOURLY_ROWS
  members: int = 64
  batch_size: int | None = None  # None: full batch.
  learning_rate: float = 0.005
  timed_epochs: int = 10


def _both(cell, precisions=('f32',), **kwargs):
  return [Leg(cell, backend, precision, **kwargs)
          for precision in precisions for backend in ('kernel', 'torch')]


CELLS = {
    'main': _both('main', ('f32', 'bf16')),
    'widths': [Leg('widths', 'kernel', width=w) for w in (256, 768, 1024)],
    'sst': _both('sst', ('f32', 'bf16'), dataset='sst', rows=SST_ROWS,
                 members=16, timed_epochs=3),
    'nb': _both('nb', likelihood='NB'),
    'vi': _both('vi', objective='vi', members=16, batch_size=3_500,
                learning_rate=0.01, timed_epochs=3),
}
# The air_quality VI stanza's other settings (`cli/registry.py`).
VI_DRAWS = 5
VI_KL_WEIGHT = 0.2


def hourly_table(rows, seed, counts=False):
  """bench.py's workload: hourly time, two coordinates, a seasonal target
  (NB: poisson(exp(y / 8) + 1) drawn from the seed)."""
  rng = np.random.default_rng(seed)
  t = np.arange(rows)
  space = rng.normal(size=(rows, 2))
  y = (10 * np.sin(2 * np.pi * t / 24.0)
       + 3 * np.sin(2 * np.pi * t / (24.0 * 7))
       + space[:, 0] + rng.normal(size=rows))
  if counts:
    y = rng.poisson(np.exp(y / 8.0) + 1.0).astype(np.float64)
  return pd.DataFrame({
      'datetime': pd.Timestamp('2021-01-01') + pd.to_timedelta(t, unit='h'),
      'latitude': space[:, 0], 'longitude': space[:, 1], 'pm10': y,
  })


def sst_table(rows, seed, locations=SST_LOCATIONS):
  """sst's shape: monthly rows over a lat/lon grid, with a per-month
  Southern Oscillation Index (soi) input."""
  rng = np.random.default_rng(seed)
  months = -(-rows // locations)
  lat = rng.uniform(-60, 60, size=locations)
  lon = rng.uniform(0, 360, size=locations)
  soi = rng.normal(size=months)
  month = np.repeat(np.arange(months), locations)[:rows]
  where = np.tile(np.arange(locations), months)[:rows]
  sst = (15 + 10 * np.cos(np.radians(lat[where]))
         + 2 * np.sin(2 * np.pi * month / 12) + 0.5 * soi[month]
         + 0.3 * rng.normal(size=rows))
  return pd.DataFrame({
      'datetime': pd.period_range('2000-01', periods=months,
                                  freq='M').to_timestamp()[month],
      'latitude': lat[where], 'longitude': lon[where], 'soi': soi[month],
      'sst': sst,
  })


def make_table(leg, seed):
  if leg.dataset == 'sst':
    return sst_table(leg.rows, seed)
  return hourly_table(leg.rows, seed, counts=leg.likelihood == 'NB')


def make_estimator(leg):
  data = registry.dataset_config(leg.dataset)
  model = registry.model_config(leg.dataset, 'map')
  if leg.width is not None:
    model['width'] = leg.width
  cls = (bayesnf_torch.BayesianNeuralFieldVI if leg.objective == 'vi'
         else bayesnf_torch.BayesianNeuralFieldMAP)
  model.update(observation_model=leg.likelihood,
               feature_cols=data['feature_cols'],
               target_col=data['target_col'], timetype=data['timetype'],
               freq=data['freq'], standardize=data['standardize'])
  return cls(**model)


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _train_inputs(est, table, device):
  train = est.data_handler.get_train(table)
  config = est._field_config(train.shape)  # pylint: disable=protected-access
  aug_t = field_lib.aug_features(
      config, torch.as_tensor(train, dtype=torch.float32, device=device)
  ).T.contiguous()
  y = torch.tensor(est.data_handler.get_target(table), dtype=torch.float32,
                   device=device)
  return config, aug_t, y


def timed_epochs(leg, est, table, device):
  """One repeat: `leg.timed_epochs` epochs from the warm-up fit's
  parameters; returns (member steps, seconds, K1 launches, steps)."""
  config, aug_t, y = _train_inputs(est, table, device)
  distribution = likelihoods.LikelihoodDist(leg.likelihood)
  launches = fused_mlp.fused_train.launches
  if leg.objective == 'vi':
    steps = leg.timed_epochs * (leg.rows // leg.batch_size)
    surrogate = est.surrogate_
    state = map_lib.init_opt_state((*surrogate[0], *surrogate[1]))
    generator = torch.Generator(device=device).manual_seed(1)
    _sync(device)
    start = time.perf_counter()
    _, _, losses = vi_lib.train(
        surrogate, state, aug_t, y, config, distribution, leg.learning_rate,
        steps, leg.batch_size, VI_DRAWS, VI_KL_WEIGHT, generator,
        leg.backend, leg.precision)
  else:
    steps = leg.timed_epochs
    params = tuple(p.reshape((-1,) + tuple(p.shape[2:]))
                   for p in est.params_)
    _sync(device)
    start = time.perf_counter()
    _, _, losses = map_lib.train(
        params, map_lib.init_opt_state(params), aug_t, y, config,
        distribution, leg.learning_rate, steps, backend=leg.backend,
        precision=leg.precision)
  _sync(device)
  seconds = time.perf_counter() - start
  if not bool(torch.isfinite(losses).all()):
    raise AssertionError(f'{leg}: non-finite training loss')
  return leg.members * steps, seconds, fused_mlp.fused_train.launches - (
      launches), steps


def timed_predict(leg, est, table, device):
  """One predict call; returns (ms, K2 launches)."""
  launches = fused_mlp.fused_field_mlp_t.launches
  _sync(device)
  start = time.perf_counter()
  means, quantiles = est.predict(table, quantiles=QUANTILES,
                                 backend=leg.backend)
  _sync(device)
  ms = (time.perf_counter() - start) * 1e3
  if not (bool(torch.isfinite(means).all())
          and all(bool(torch.isfinite(q).all()) for q in quantiles)):
    raise AssertionError(f'{leg}: non-finite prediction')
  p50, lower, upper = quantiles
  if not (bool((lower <= p50).all()) and bool((p50 <= upper).all())):
    raise AssertionError(f'{leg}: quantiles out of order')
  if means.shape[-1] != len(table):
    raise AssertionError(f'{leg}: means of shape {tuple(means.shape)}')
  return ms, fused_mlp.fused_field_mlp_t.launches - launches


def _check_launches(leg, what, launches, expected):
  want = expected if leg.backend == 'kernel' else 0
  if launches != want:
    raise AssertionError(f'{leg}: {launches} {what} launches, expected {want}')


def run_leg(leg, repeats, seed, device, card):
  """Warm-up fit, `repeats` timed runs of epochs, PREDICT_CALLS predicts;
  returns the leg's JSON object."""
  device = torch.device(device)
  table = make_table(leg, seed)
  est = make_estimator(leg)
  fit_kwargs = dict(ensemble_size=leg.members,
                    learning_rate=leg.learning_rate, num_epochs=1,
                    batch_size=leg.batch_size, backend=leg.backend,
                    device=device, precision=leg.precision)
  if leg.objective == 'vi':
    fit_kwargs.update(sample_size_divergence=VI_DRAWS,
                      kl_weight=VI_KL_WEIGHT)
  _sync(device)
  start = time.perf_counter()
  est.fit(table, seed, **fit_kwargs)
  _sync(device)
  warmup_s = time.perf_counter() - start

  rates = []
  for _ in range(repeats):
    member_steps, seconds, launches, steps = timed_epochs(leg, est, table,
                                                          device)
    _check_launches(leg, 'K1', launches, steps)
    rates.append(member_steps / seconds)
  predict_ms = []
  chunks = math.ceil(len(table) / PREDICT_CHUNK)
  for _ in range(PREDICT_CALLS):
    ms, launches = timed_predict(leg, est, table, device)
    _check_launches(leg, 'K2', launches, chunks)
    predict_ms.append(ms)

  rates, predict_ms = np.asarray(rates), np.asarray(predict_ms)
  median = float(np.median(rates))
  width = leg.width or registry.model_config(leg.dataset, 'map')['width']
  return {
      'cell': leg.cell, 'objective': leg.objective,
      'likelihood': leg.likelihood, 'backend': leg.backend,
      'precision': leg.precision, 'width': width, 'depth': 2,
      'rows': len(table), 'members': leg.members,
      'batch_size': leg.batch_size or len(table),
      'steps_per_repeat': steps, 'repeats': repeats,
      'member_steps_per_s': {
          'median': median, 'min': float(rates.min()),
          'max': float(rates.max()),
          'spread': float((rates.max() - rates.min()) / median),
          'runs': rates.tolist()},
      'predict_ms': {
          'calls': len(predict_ms),
          'p50': float(np.percentile(predict_ms, 50)),
          'p90': float(np.percentile(predict_ms, 90)),
          'min': float(predict_ms.min()), 'max': float(predict_ms.max()),
          'runs': predict_ms.tolist()},
      'warmup_fit_s': warmup_s,
      'card': card,
  }


def card_line():
  """The card's `name, power.limit`, as nvidia-smi prints them."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip().splitlines(
      )[0]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--cells', default=','.join(CELLS),
                      help=f'Comma-separated subset of {",".join(CELLS)}.')
  parser.add_argument('--repeats', type=int, default=DEFAULT_REPEATS)
  parser.add_argument('--seed', type=int, default=0)
  args = parser.parse_args(argv)
  cells = args.cells.split(',')
  unknown = sorted(set(cells) - set(CELLS))
  if unknown:
    parser.error(f'unknown cells {unknown}')

  if not torch.cuda.is_available():
    print('bench_torch: CUDA is not available; the bench leg runs on a GPU.',
          file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  card = card_line()
  print(card, flush=True)
  for cell in cells:
    for leg in CELLS[cell]:
      print(json.dumps(run_leg(leg, args.repeats, args.seed, 'cuda', card)),
            flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
