"""Worker of the port's multi-process tests (not a pytest module).

    python _torch_distributed_worker.py <rank> <world> <port> <scenario> <out>

Joins a Gloo group of `world` ranks at tcp://localhost:<port> (one CPU
thread each), prints `INIT_SENTINEL` after a warm-up all_gather, runs
`SCENARIOS[<scenario>]` over meshes of 'cpu' cells dealt to the ranks in
order (`rank_mesh`), and writes every array it computed to
<out>/rank<rank>.npz. The tests run the same scenario in one process over
the single-process mesh of each layout (`single_mesh`) and compare the
bits.
"""

import datetime
import os
import sys

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# pylint: disable=g-import-not-at-top,wrong-import-position
import bayesnf_torch
from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.parallel import distributed
from bayesnf_torch.parallel import mesh as mesh_lib

INIT_SENTINEL = 'WORKER_INIT_OK'
# A rank that raises leaves its peers in a collective for this long.
TIMEOUT = datetime.timedelta(seconds=120)

ESTIMATOR_KWARGS = dict(
    feature_cols=['datetime', 'lat', 'lon'], target_col='y',
    timetype='index', freq='h', standardize=['lat', 'lon'], width=16,
    depth=2, fourier_degrees=[2, 2, 2], interactions=[(1, 2)],
    seasonality_periods=[24, 168], num_seasonal_harmonics=[4, 4])
# 75 rows: 38 / 37 over two data shards, so n_valid masks a tail.
TABLE_HOURS = 25
TABLE_SITES = 3
MINIBATCH = 30  # 15 rows a shard a step over two data shards.

PREDICT_CONFIG = dict(
    width=16, depth=2, input_scales=[23.0, 1.0, 1.0],
    fourier_degrees=[2, 1, 1], interactions=[(0, 1)],
    seasonality_periods=[24.0], num_seasonal_harmonics=[3])
PREDICT_ROWS = 45  # chunks of 16 rows: the last one ragged.
PREDICT_CHUNK = 16
QUANTILES = (0.5, 0.1, 0.9)


def table(n_hours=TABLE_HOURS, sites=TABLE_SITES, seed=0):
  """An hourly table of `sites` sites."""
  rng = np.random.default_rng(seed)
  coords = rng.normal(size=(sites, 2))
  times = pd.date_range('2021-03-01', periods=n_hours, freq='h')
  df = pd.DataFrame([(t, lat, lon) for t in times for lat, lon in coords],
                    columns=['datetime', 'lat', 'lon'])
  hours = np.arange(len(df)) // sites
  df['y'] = (np.sin(2 * np.pi * hours / 24.0) + df['lat']
             + 0.1 * rng.normal(size=len(df)))
  return df


def predict_inputs(param_specs, seed=5):
  """(parameter arrays (1, 4, ...) of the given specs, features (N, 3)),
  float32 numpy, made from `seed`."""
  rng = np.random.default_rng(seed)
  arrays = [
      (np.clip(rng.normal(size=(1, 4) + s.shape), -2, 2) if s.is_matrix
       else rng.normal(scale=0.5, size=(1, 4) + s.shape)).astype(np.float32)
      for s in param_specs
  ]
  x = np.concatenate([rng.uniform(0, 23, (PREDICT_ROWS, 1)),
                      rng.normal(size=(PREDICT_ROWS, 2))],
                     axis=1).astype(np.float32)
  return arrays, x


def rank_mesh(ens, data):
  """The (ens, data) mesh of 'cpu' cells dealt to the group's ranks in
  order, row by row."""
  cells, world = ens * data, torch.distributed.get_world_size()
  return mesh_lib.default_mesh(
      ['cpu'] * cells, ens, data,
      ranks=[c * world // cells for c in range(cells)])


def single_mesh(ens, data):
  """The single-process mesh of the same layout."""
  return mesh_lib.default_mesh(['cpu'] * (ens * data), ens, data)


def _arrays(out, prefix, tensors):
  for i, t in enumerate(tensors):
    out[f'{prefix}/{i}'] = torch.as_tensor(t).detach().cpu().numpy()


def _map_fit(out, key, mesh, **kwargs):
  est = bayesnf_torch.BayesianNeuralFieldMAP(**ESTIMATOR_KWARGS).fit(
      table(), seed=0, ensemble_size=4, device='cpu', mesh=mesh, **kwargs)
  out[f'{key}/losses'] = est.losses_
  _arrays(out, f'{key}/params', est.params_)
  return est


def _vi_fit(out, key, mesh, **kwargs):
  est = bayesnf_torch.BayesianNeuralFieldVI(**ESTIMATOR_KWARGS).fit(
      table(), seed=1, ensemble_size=4, sample_size_posterior=3,
      sample_size_divergence=2, device='cpu', mesh=mesh, **kwargs)
  out[f'{key}/losses'] = est.losses_
  _arrays(out, f'{key}/draws', est.params_)
  _arrays(out, f'{key}/surrogate', (*est.surrogate_[0], *est.surrogate_[1]))
  return est


def _predicts(out, key, mesh, **kwargs):
  config = field_lib.FieldConfig.create(**PREDICT_CONFIG)
  arrays, x = predict_inputs(field_lib.param_specs(config))
  params = field_lib.params_from_numpy(config, arrays, 2, 'cpu')
  means, quantiles = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, QUANTILES, chunk_size=PREDICT_CHUNK,
      mesh=mesh, **kwargs)
  out[f'{key}/means'] = means.numpy()
  _arrays(out, f'{key}/quantiles', quantiles)
  _arrays(out, f'{key}/forecast', predict_lib.forecast_params_bnf(
      x, 'NORMAL', params, config, chunk_size=PREDICT_CHUNK, mesh=mesh,
      **kwargs))


def tier1(mesh_of, work_dir):
  """MAP and VI full batch over ens 2 x data 1 and 1 x 2, a minibatch MAP
  over 1 x 2, the predicts over 1 x 2; the 2 x 1 MAP fit saved."""
  out = {}
  for ens, data in ((2, 1), (1, 2)):
    est = _map_fit(out, f'map-{ens}x{data}', mesh_of(ens, data),
                   num_epochs=3)
    if (ens, data) == (2, 1) and _writes():
      est.save(os.path.join(work_dir, 'map-2x1.npz'))
    _vi_fit(out, f'vi-{ens}x{data}', mesh_of(ens, data), num_epochs=2)
  _map_fit(out, 'map-minibatch-1x2', mesh_of(1, 2), num_epochs=2,
           batch_size=MINIBATCH)
  _predicts(out, 'predict-1x2', mesh_of(1, 2))
  return out


def streamed(mesh_of, work_dir):
  """Streamed MAP (shared and remixed) and VI fits over 1 x 2, and the
  streamed predicts over 1 x 2 beside the in-memory ones."""
  del work_dir
  out = {}
  stream = dict(batch_size=MINIBATCH, stream_chunk_steps=2)
  _map_fit(out, 'map-stream', mesh_of(1, 2), num_epochs=2, **stream)
  _map_fit(out, 'map-remix', mesh_of(1, 2), num_epochs=2,
           stream_member_remix=True, **stream)
  _vi_fit(out, 'vi-stream', mesh_of(1, 2), num_epochs=2, **stream)
  _predicts(out, 'predict', mesh_of(1, 2))
  _predicts(out, 'predict-stream', mesh_of(1, 2),
            stream_chunk_rows=PREDICT_CHUNK)
  return out


def checkpointed(mesh_of, work_dir):
  """A MAP fit over 1 x 2 and a VI fit over 2 x 1, each straight and
  stopped then resumed in the same directory (the lowest rank writes)."""
  out = {}
  for kind, fit, layout, total in (('map', _map_fit, (1, 2), 4),
                                   ('vi', _vi_fit, (2, 1), 2)):
    fit(out, f'{kind}-straight', mesh_of(*layout), num_epochs=total)
    ckdir = os.path.join(work_dir, f'ckpt-{kind}')
    fit({}, f'{kind}-stopped', mesh_of(*layout), num_epochs=total // 2,
        checkpoint_dir=ckdir, checkpoint_every=1)
    fit(out, f'{kind}-resumed', mesh_of(*layout), num_epochs=total,
        checkpoint_dir=ckdir, checkpoint_every=1)
  return out


def grid(mesh_of, work_dir):
  """The 2 x 2 grid (one cell a rank with four ranks): MAP full batch,
  minibatch and streamed, VI, and the predicts."""
  del work_dir
  out = {}
  _map_fit(out, 'map', mesh_of(2, 2), num_epochs=3)
  _map_fit(out, 'map-minibatch', mesh_of(2, 2), num_epochs=2,
           batch_size=MINIBATCH)
  _map_fit(out, 'map-stream', mesh_of(2, 2), num_epochs=2,
           batch_size=MINIBATCH, stream_chunk_steps=2)
  _vi_fit(out, 'vi', mesh_of(2, 2), num_epochs=2)
  _predicts(out, 'predict', mesh_of(2, 2))
  return out


SCENARIOS = {'tier1': tier1, 'streamed': streamed,
             'checkpointed': checkpointed, 'grid': grid}


def _writes():
  """Whether this process writes shared files: rank 0, or one process."""
  return (not torch.distributed.is_initialized()
          or torch.distributed.get_rank() == 0)


def main():
  rank, world, port = map(int, sys.argv[1:4])
  scenario, out_dir = sys.argv[4], sys.argv[5]
  torch.set_num_threads(1)
  distributed.initialize(f'localhost:{port}', world, rank, backend='gloo',
                         timeout=TIMEOUT)
  # A plain collective before the sentinel: the group is formed. Product
  # code runs only after it, so a fault there is never retried.
  ranks = [torch.zeros(1) for _ in range(world)]
  torch.distributed.all_gather(ranks, torch.tensor([float(rank)]))
  assert [int(r) for r in ranks] == list(range(world)), ranks
  print(INIT_SENTINEL, flush=True)
  out = SCENARIOS[scenario](rank_mesh, out_dir)
  np.savez(os.path.join(out_dir, f'rank{rank}.npz'), **out)
  torch.distributed.barrier()
  torch.distributed.destroy_process_group()
  print('WORKER_DONE', flush=True)


if __name__ == '__main__':
  main()
