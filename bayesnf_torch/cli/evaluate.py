"""Experiment CLI: train + predict on the paper's spatiotemporal datasets
(counterpart of `bayesnf_tpu/cli/evaluate.py`).

Per (objective, dataset, series) run it writes the reference harness's
three artifacts:

- ``bnf-{objective}.{dataset}.{series}.log.json``: runtime, the metrics
  block (rmse, mae and fair CRPS per region) and the configs;
- ``...loss.csv``: per-particle loss curves (columns = particles);
- ``...pred.csv``: yhat (ensemble mean), yhat_p50 / yhat_lower /
  yhat_upper at quantiles (0.5, 0.025, 0.975), every row of train + test,
  sorted by the original index.

Usage, on a CUDA card (the default) or on the CPU:
  python -m bayesnf_torch.cli.evaluate --dataset=chickenpox --objective=map \\
      --data_root=/path/to/csvs --output_dir=/tmp/out --start_id=5 \\
      --stop_id=6 [--device=cpu] [--backend=kernel|torch|auto]

Input files follow the reference layout: ``{dataset}.{series}.train.csv``
and ``{dataset}.{series}.test.csv`` with a ``datetime`` column.

Differences from the JAX package's CLI: seeds are ints
(``2023100400 + series_id``); the CRPS draws come from a `torch.Generator`
seeded with `map.stream_seed(seed, map.CRPS_STREAM)` where the JAX package
folds 1 into its key (an RNG deviation: the draws differ, the estimator is
the same); `--data_devices` makes a single-process mesh.
`--stream_chunk_steps` and `--stream_member_remix` stream the fit
(`parallel/streaming.py`), with the port's batch schedule (its own entropy
and remix RNG). `--stream_chunk_rows` streams the predict (`inference/predict_stream.py`) and the CRPS draws: each chunk
of that many rows gets its own streamed `likelihood_model` and its draws
from a generator seeded `map.stream_seed(seed, map.CRPS_STREAM, chunk)`,
as the JAX package folds one key per chunk, so a streamed run's CRPS draws
differ from an in-memory run's (`log.json` says which: `crps_draws`).
`--stream_cache_bytes` is accepted for the JAX package's flags and ignored:
the streamed predict keeps no device cache.
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import pandas as pd
import torch

from bayesnf_torch import metrics as metrics_lib
from bayesnf_torch import spatiotemporal
from bayesnf_torch.cli import registry
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.utils import profiling

_ESTIMATORS = {
    'map': spatiotemporal.BayesianNeuralFieldMAP,
    'mle': spatiotemporal.BayesianNeuralFieldMLE,
    'vi': spatiotemporal.BayesianNeuralFieldVI,
}

# Posterior-predictive draws per member for the CRPS, as the JAX package.
CRPS_DRAWS = 8


def _on_device(value, device):
  """A distribution object of `models/distributions.py` with its tensors on
  `device`."""
  if isinstance(value, torch.Tensor):
    return value.to(device)
  if dataclasses.is_dataclass(value):
    return dataclasses.replace(value, **{
        f.name: _on_device(getattr(value, f.name), device)
        for f in dataclasses.fields(value)})
  return value


def _crps_draws(model, df_all, seed, backend, stream_rows):
  """(CRPS_DRAWS x members, rows) posterior-predictive draws as numpy: from
  one `likelihood_model` and one generator, or, with `stream_rows`, from a
  streamed one a chunk of that many rows, each with a generator of its own
  (`map.stream_seed(seed, map.CRPS_STREAM, chunk)`), so that the device
  holds one chunk's draws at a time."""
  device = model.params_[0].device
  if stream_rows is None:
    generator = torch.Generator(device=device).manual_seed(
        map_lib.stream_seed(seed, map_lib.CRPS_STREAM))
    dist = model.likelihood_model(df_all, backend=backend)
    # Every leading (draw and ensemble) axis flattens into the sample axis.
    return dist.sample(generator, (CRPS_DRAWS,)).reshape(
        -1, len(df_all)).cpu().numpy()
  parts = []
  for ci, lo in enumerate(range(0, len(df_all), stream_rows)):
    sub = df_all.iloc[lo:lo + stream_rows]
    generator = torch.Generator(device=device).manual_seed(
        map_lib.stream_seed(seed, map_lib.CRPS_STREAM, ci))
    dist = _on_device(model.likelihood_model(
        sub, backend=backend, stream_chunk_rows=stream_rows), device)
    parts.append(dist.sample(generator, (CRPS_DRAWS,)).reshape(
        -1, len(sub)).cpu().numpy())
  return np.concatenate(parts, axis=1)


def _mesh_devices(device):
  """The devices a `data_devices` mesh spans: `device` itself when it is a
  list (entries may repeat), else every device of its type."""
  if isinstance(device, (list, tuple)):
    return list(device)
  device = torch.device(device)
  if device.type == 'cuda':
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
  return [device]


def run_experiment(
    dataset: str,
    data_root: str,
    series_id,
    output_dir: str,
    objective: str,
    seed: int,
    dataset_config: dict | None = None,
    model_config: dict | None = None,
    inference_config: dict | None = None,
    quantiles=(0.5, 0.025, 0.975),
    device='cuda',
):
  """Train one series, predict train+test, write the three artifacts.

  Args:
    dataset: registry name of the dataset.
    data_root: directory of the ``{dataset}.{series_id}.{train,test}.csv``.
    series_id: the series' id as it appears in the file names.
    output_dir: where the artifacts go (created if missing).
    objective: 'map' | 'mle' | 'vi'.
    seed: int seed of the fit; the CRPS draws use
      `map.stream_seed(seed, map.CRPS_STREAM)` (streamed, with the chunk's
      index).
    dataset_config, model_config, inference_config: override the
      registry's stanzas. `inference_config` may also hold 'backend'
      ('auto' | 'torch' | 'kernel', for the fit, the predict and the
      likelihood model), 'precision', 'data_devices', the fit's
      'stream_chunk_steps' and 'stream_member_remix', and the predict's
      'stream_chunk_rows' and 'stream_cache_bytes'.
    quantiles: the predicted quantiles (the CSV names three).
    device: where the fit runs; with 'data_devices' the mesh spans every
      device of its type, or the devices of a list given here (the CPU
      tests pass a repeated 'cpu').

  Returns:
    (losses_ as numpy, means, quantiles) of the fitted estimator, the last
    two tensors on its parameters' device (a streamed predict's on the
    CPU).
  """
  dataset_config = dataset_config or registry.dataset_config(dataset)
  model_config = dict(model_config or registry.model_config(dataset, objective))
  inference_config = dict(
      inference_config or registry.inference_config(dataset, objective)
  )

  df_train = pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.train.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )
  df_test = pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.test.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )

  os.makedirs(output_dir, exist_ok=True)
  stem = os.path.join(output_dir, f'bnf-{objective}.{dataset}.{series_id}')

  model_config.update(
      feature_cols=dataset_config['feature_cols'],
      target_col=dataset_config['target_col'],
      timetype=dataset_config['timetype'],
      freq=dataset_config.get('freq'),
      standardize=dataset_config.get('standardize'),
  )

  fit_kwargs = dict(
      learning_rate=inference_config['learning_rate'],
      num_epochs=inference_config['num_epochs'],
      batch_size=inference_config.get('batch_size'),
      ensemble_size=inference_config['num_particles'],
  )
  for key in ('backend', 'precision', 'stream_chunk_steps',
              'stream_member_remix'):
    if key in inference_config:
      fit_kwargs[key] = inference_config[key]
  if inference_config.get('data_devices'):
    fit_kwargs['mesh'] = mesh_lib.default_mesh(
        _mesh_devices(device),
        data_devices=int(inference_config['data_devices']),
    )
  else:
    fit_kwargs['device'] = device
  if objective == 'vi':
    fit_kwargs.update(
        kl_weight=inference_config.get('kl_weight', 1.0),
        sample_size_divergence=inference_config.get(
            'sample_size_divergence', 10
        ),
    )
  else:
    fit_kwargs.update(
        num_splits=inference_config.get('num_particle_splits', 1)
    )
  backend = inference_config.get('backend', 'auto')
  stream_rows = inference_config.get('stream_chunk_rows')

  start = time.perf_counter()
  with profiling.maybe_trace(os.environ.get('BNF_PROFILE_DIR')):
    model = _ESTIMATORS[objective](**model_config).fit(
        df_train, seed, **fit_kwargs
    )
    df_all = pd.concat([df_train, df_test])
    means, quants = model.predict(df_all, quantiles=quantiles,
                                  backend=backend,
                                  stream_chunk_rows=stream_rows)
    if means.is_cuda:
      # Predict returns before the card is done.
      torch.cuda.synchronize(means.device)
  runtime = time.perf_counter() - start
  losses = model.losses_

  # `means`/`draws` cover every row of df_all (prediction keeps NaN-target
  # rows); metrics restrict POSITIONALLY to the valid-target rows. The
  # train/test split is positional too: concat preserves row order, and
  # train/test CSVs routinely reuse index labels, so index-set membership
  # would mislabel test rows.
  target_col = dataset_config['target_col']
  valid = df_all[target_col].notna().to_numpy()
  y_all = df_all.loc[valid, target_col].to_numpy(dtype=np.float64)
  means_host = means.cpu().numpy()  # one device->host copy
  yhat_all = means_host.mean(
      axis=tuple(range(means_host.ndim - 1))
  )[valid]
  draws = _crps_draws(model, df_all, seed, backend, stream_rows)[:, valid]
  n_train_valid = int(df_train[target_col].notna().sum())
  is_train = np.arange(len(y_all)) < n_train_valid
  metrics_block = {}
  for region, mask in (('train', is_train), ('test', ~is_train)):
    if not np.any(mask):
      continue
    metrics_block[region] = {
        'rmse': float(metrics_lib.rmse(y_all[mask], yhat_all[mask])),
        'mae': float(metrics_lib.mae(y_all[mask], yhat_all[mask])),
        'crps': float(
            metrics_lib.crps_ensemble(y_all[mask], draws[:, mask], fair=True)
        ),
    }

  with open(f'{stem}.log.json', 'w') as f:
    json.dump(
        {
            'dataset': dataset,
            'series_id': series_id,
            'runtime': runtime,
            'objective': objective,
            'metrics': metrics_block,
            'crps_draws': 'single' if stream_rows is None else 'chunked',
            'dataset_config': dataset_config,
            'model_config': model_config,
            'inference_config': inference_config,
        },
        f,
        indent=2,
        default=repr,
    )

  loss_df = pd.DataFrame(np.reshape(losses, (-1, losses.shape[-1])).T)
  loss_df.to_csv(f'{stem}.loss.csv', index=False)

  # Predictions cover EVERY row of df_all (NaN-target rows are legitimate
  # grid points), so the artifact indexes all of them.
  pred_df = pd.DataFrame(
      {
          'yhat': means_host.mean(axis=tuple(range(means_host.ndim - 1))),
          'yhat_p50': quants[0].cpu().numpy(),
          'yhat_lower': quants[1].cpu().numpy(),
          'yhat_upper': quants[2].cpu().numpy(),
      },
      index=df_all.index,
  )
  pred_df.sort_index(inplace=True)
  pred_df.to_csv(f'{stem}.pred.csv', index=True)

  return losses, means, quants


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--data_root', required=True)
  parser.add_argument(
      '--dataset', required=True, choices=registry.runnable_datasets()
  )
  parser.add_argument(
      '--objective', default='map', choices=['map', 'mle', 'vi']
  )
  parser.add_argument('--start_id', type=int, default=5)
  parser.add_argument('--stop_id', type=int, default=None)
  parser.add_argument(
      '--num_particles', type=int, default=None,
      help='Override the ensemble size.',
  )
  parser.add_argument(
      '--backend', default=None, choices=['auto', 'torch', 'kernel'],
      help='Backend of the fit, the predict and the CRPS draws: kernel = '
      'the hand-written CUDA kernels; torch = plain PyTorch; auto (the '
      'default) = kernel on CUDA, torch on the CPU.',
  )
  parser.add_argument(
      '--precision', default=None, choices=['f32', 'bf16', 'highest'],
      help='Matmul precision of the fit (all objectives, both backends).',
  )
  parser.add_argument(
      '--device', default='cuda',
      help="Device of the fit and the predict ('cuda', 'cuda:1', 'cpu').",
  )
  parser.add_argument(
      '--data_devices', type=int, default=None,
      help="Devices on the mesh's 'data' axis (rows sharded; the rest of "
      "the device type's devices go to 'ens'). Default: no mesh.",
  )
  parser.add_argument(
      '--num_epochs', type=int, default=None,
      help='Override the registry epoch budget (smoke runs).',
  )
  parser.add_argument(
      '--batch_size', type=int, default=None,
      help='Override the registry batch size.',
  )
  parser.add_argument(
      '--stream_chunk_steps', type=int, default=None,
      help='Host-streaming training: keep the dataset in host RAM and '
      'stream batches in slices of this many SGD steps (requires the '
      "config's batch_size < rows; --batch_size overrides it).",
  )
  parser.add_argument(
      '--stream_chunk_rows', type=int, default=None,
      help='Out-of-core prediction: the rows stream through the device in '
      'chunks of this many rows, and so do the CRPS draws, a generator seed '
      'per chunk (log.json: "crps_draws": "chunked"), so their values '
      "differ from an in-memory run's.",
  )
  parser.add_argument(
      '--stream_cache_bytes', type=int, default=None,
      help="Accepted for the JAX package's flags and ignored: the streamed "
      'predictor keeps no device cache (device memory stays O(chunk)).',
  )
  parser.add_argument(
      '--stream_member_remix', action='store_true',
      help='With --stream_chunk_steps: each member repartitions every '
      "slice's rows into its own batches on the device (the slice size is "
      'then the remix window).',
  )
  args = parser.parse_args(argv)

  data_cfg = registry.dataset_config(args.dataset)
  stop_id = args.stop_id if args.stop_id is not None else data_cfg['num_series']
  overrides = {
      'num_particles': args.num_particles,
      'backend': args.backend,
      'precision': args.precision,
      'data_devices': args.data_devices,
      'num_epochs': args.num_epochs,
      'batch_size': args.batch_size,
      'stream_chunk_steps': args.stream_chunk_steps,
      'stream_member_remix': args.stream_member_remix or None,
      'stream_chunk_rows': args.stream_chunk_rows,
      'stream_cache_bytes': args.stream_cache_bytes,
  }
  for series_id in range(args.start_id, stop_id):
    inference = registry.inference_config(args.dataset, args.objective)
    # `is not None` (not truthiness) so an explicit 0 reaches fit()'s own
    # validation instead of falling back to the registry's value.
    inference.update({k: v for k, v in overrides.items() if v is not None})
    sid = data_cfg['series_id_fmt'](series_id)
    print(f'{args.dataset} series {sid} ({args.objective})')
    run_experiment(
        dataset=args.dataset,
        data_root=args.data_root,
        series_id=sid,
        output_dir=args.output_dir,
        objective=args.objective,
        inference_config=inference,
        seed=2023100400 + series_id,
        device=args.device,
    )


if __name__ == '__main__':
  main()
