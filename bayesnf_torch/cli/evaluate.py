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
the same); `--data_devices` makes a single-process mesh; the streaming
flags raise NotImplementedError until the port has streaming.
"""

import argparse
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

_STREAM_KEYS = ('stream_chunk_steps', 'stream_member_remix',
                'stream_chunk_rows', 'stream_cache_bytes')


def _check_in_memory(inference_config):
  """Raises NotImplementedError if the config asks for streaming."""
  # By identity: a budget of 0 asks for streaming too.
  asked = [k for k in _STREAM_KEYS
           if inference_config.get(k) is not None
           and inference_config.get(k) is not False]
  if asked:
    raise NotImplementedError(
        f'{", ".join(asked)}: host-streaming training (ROADMAP.md, queue 1 '
        'item 12) and the streamed predict (item 13) are not ported to '
        'PyTorch yet.'
    )


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
      `map.stream_seed(seed, map.CRPS_STREAM)`.
    dataset_config, model_config, inference_config: override the
      registry's stanzas. `inference_config` may also hold 'backend'
      ('auto' | 'torch' | 'kernel', for the fit, the predict and the
      likelihood model), 'precision' and 'data_devices'.
    quantiles: the predicted quantiles (the CSV names three).
    device: where the fit runs; with 'data_devices' the mesh spans every
      device of its type, or the devices of a list given here (the CPU
      tests pass a repeated 'cpu').

  Returns:
    (losses_ as numpy, means, quantiles) of the fitted estimator, the last
    two tensors on its parameters' device.

  Raises:
    NotImplementedError: if `inference_config` asks for streaming.
  """
  dataset_config = dataset_config or registry.dataset_config(dataset)
  model_config = dict(model_config or registry.model_config(dataset, objective))
  inference_config = dict(
      inference_config or registry.inference_config(dataset, objective)
  )
  _check_in_memory(inference_config)

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
  for key in ('backend', 'precision'):
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

  start = time.perf_counter()
  with profiling.maybe_trace(os.environ.get('BNF_PROFILE_DIR')):
    model = _ESTIMATORS[objective](**model_config).fit(
        df_train, seed, **fit_kwargs
    )
    df_all = pd.concat([df_train, df_test])
    means, quants = model.predict(df_all, quantiles=quantiles,
                                  backend=backend)
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
  generator = torch.Generator(device=model.params_[0].device).manual_seed(
      map_lib.stream_seed(seed, map_lib.CRPS_STREAM))
  dist = model.likelihood_model(df_all, backend=backend)
  # Every leading (draw and ensemble) axis flattens into the sample axis.
  draws = dist.sample(generator, (CRPS_DRAWS,)).reshape(
      -1, len(valid)).cpu().numpy()[:, valid]
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


_NOT_PORTED = (
    'Not ported to PyTorch yet: setting it raises NotImplementedError '
    '(ROADMAP.md, queue 1 item {item}).'
)
_STREAMED_CRPS = (
    ' Once ported, the streamed CRPS draws will use one generator seed per '
    'row chunk, as the JAX package folds one key per chunk, so their values '
    'will differ from an in-memory run\'s.'
)


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
      help='Host-streaming training in slices of this many SGD steps. '
      + _NOT_PORTED.format(item=12),
  )
  parser.add_argument(
      '--stream_chunk_rows', type=int, default=None,
      help='Out-of-core prediction in chunks of this many rows. '
      + _NOT_PORTED.format(item=13) + _STREAMED_CRPS,
  )
  parser.add_argument(
      '--stream_cache_bytes', type=int, default=None,
      help='With --stream_chunk_rows: device cache budget of the streamed '
      'predictor. ' + _NOT_PORTED.format(item=13) + _STREAMED_CRPS,
  )
  parser.add_argument(
      '--stream_member_remix', action='store_true',
      help='With --stream_chunk_steps: per-member slice repartitioning. '
      + _NOT_PORTED.format(item=12),
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
