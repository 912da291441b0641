"""Competitor-method baseline harness (counterpart of
`bayesnf_tpu/cli/evaluate_baseline.py`, a copy on the port's registry,
data handler and seasonal frequency table).

Covers the reference's baseline suite (`scripts/evaluate_baseline.py`) with
one CLI over a method registry, emitting the same artifact schema per run:

- ``{method}.{dataset}.{series}.log.csv``  — epoch, runtime, rmse, nlpd
- ``{method}.{dataset}.{series}.pred.csv`` — yhat, yhat_std, yhat_lower,
  yhat_upper over train+test rows, sorted by original index.

Methods:

- ``RF``      — RandomForest point predictions (sklearn).
- ``GBOOST``  — GradientBoosting quantile regression at {2.5, 50, 97.5}%
  (sklearn), optionally on BayesNF's own seasonal/Fourier features.
- ``TSREG``   — trend-surface OLS/RIDGE/LASSO on BayesNF features with a
  residual-variance Gaussian band (sklearn).
- ``SVGP``   — GPflow sparse variational GP with natural gradients
  (`baseline_gp.run_svgp`).
- ``ST-SVGP`` / ``MF-ST-SVGP`` — BayesNewton spatiotemporal state-space
  GPs on a dense (time x space) grid (`baseline_gp.run_st_svgp`).
- ``NF``     — NeuralForecast NBEATS-family models (`baseline_nf.run_nf`).

The GP/NF drivers import their heavy dependencies (gpflow+tensorflow,
bayesnewton+objax, neuralforecast) lazily at run time and exit with a
clear message when one is missing.

Usage:
  python -m bayesnf_torch.cli.evaluate_baseline --algorithm=GBOOST \
      --dataset=chickenpox --data_root=... --output_dir=... \
      --start_id=8 --stop_id=9
"""

import argparse
import functools
import os
import time

import numpy as np
import pandas as pd

from bayesnf_torch.cli import registry
from bayesnf_torch.data import SpatiotemporalDataHandler
from bayesnf_torch.models import features as feat_lib


def load_series(data_root, dataset, series_id):
  cfg = registry.dataset_config(dataset)
  read = lambda split: pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.{split}.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )
  df_train, df_test = read('train'), read('test')
  handler = SpatiotemporalDataHandler(
      cfg['feature_cols'],
      cfg['target_col'],
      cfg['timetype'],
      cfg.get('freq'),
      standardize=cfg.get('standardize'),
  )
  x_train = handler.get_train(df_train)
  y_train = handler.get_target(df_train)
  x_test = handler.get_test(handler.copy_and_filter_table(df_test))
  y_test = handler.get_target(df_test)
  idx_train = handler.copy_and_filter_table(df_train).index
  idx_test = handler.copy_and_filter_table(df_test).index
  return x_train, y_train, x_test, y_test, idx_train, idx_test


def featurize(x, dataset=None, seasonality_periods=None,
              num_seasonal_harmonics=None):
  """Seasonal + Fourier featurization (the reference's TSREG/GBOOST prep).

  Pure numpy on purpose: the sklearn baselines must not touch an
  accelerator (and must run even when no device backend is reachable).
  Seasonality comes from the registry's MAP model config for `dataset`,
  or explicitly via `seasonality_periods`/`num_seasonal_harmonics` (the
  synthetic head-to-head leg, whose protocol is not a registry dataset).
  """
  if dataset is not None:
    model_cfg = registry.model_config(dataset, 'map')
    seasonality_periods = model_cfg['seasonality_periods']
    num_seasonal_harmonics = model_cfg['num_seasonal_harmonics']
  freqs, harms = feat_lib.seasonal_frequency_table(
      seasonality_periods, num_seasonal_harmonics
  )
  x = np.asarray(x, dtype=np.float64)
  cols = [x]
  for i in range(x.shape[1]):  # octave Fourier features, degree 4, rescaled
    angles = 2 * np.pi * x[:, i : i + 1] * (2.0 ** np.arange(4))
    f = np.concatenate([np.cos(angles), np.sin(angles)], axis=-1)
    cols.append(f / np.tile(np.arange(1, 5), 2))
  if len(freqs):  # seasonal harmonics of raw time, unrescaled
    angles = 2 * np.pi * np.asarray(freqs) * x[:, 0:1]
    cols.append(np.concatenate([np.cos(angles), np.sin(angles)], axis=-1))
    del harms
  return np.column_stack(cols)


def _write_artifacts(output_dir, stem, runtime, rmse, pred_df):
  os.makedirs(output_dir, exist_ok=True)
  log_df = pd.DataFrame(
      dict(epoch=[0], runtime=[runtime], rmse=[rmse], nlpd=[np.nan])
  )
  log_df.to_csv(os.path.join(output_dir, f'{stem}.log.csv'), index=False)
  pred_df.sort_index(inplace=True)
  pred_df.to_csv(os.path.join(output_dir, f'{stem}.pred.csv'), index=True)
  return os.path.join(output_dir, f'{stem}.pred.csv')


def run_rf(data_root, dataset, series_id, output_dir, **_):
  from sklearn.ensemble import RandomForestRegressor

  x_tr, y_tr, x_te, y_te, i_tr, i_te = load_series(
      data_root, dataset, series_id
  )
  start = time.time()
  model = RandomForestRegressor().fit(x_tr, y_tr)
  runtime = time.time() - start
  rmse = float(np.sqrt(np.nanmean((y_te - model.predict(x_te)) ** 2)))

  x_all = np.concatenate([x_tr, x_te])
  yhat = model.predict(x_all)
  pred = pd.DataFrame(
      {
          'yhat': yhat,
          'yhat_std': np.zeros_like(yhat),
          'yhat_lower': yhat,
          'yhat_upper': yhat,
      },
      index=i_tr.append(i_te),
  )
  return _write_artifacts(
      output_dir, f'rf.{dataset}.{series_id}', runtime, rmse, pred
  )


# The GBOOST protocol hyperparameters (shared with the head-to-head
# runner so the committed artifact and the artifact CLI cannot drift).
GBOOST_PARAMS = dict(
    learning_rate=0.05, n_estimators=100, max_depth=4,
    min_samples_leaf=9, min_samples_split=9,
)


def run_gboost(
    data_root, dataset, series_id, output_dir,
    n_estimators=100, use_features=True, **_,
):
  from sklearn.ensemble import GradientBoostingRegressor

  x_tr, y_tr, x_te, y_te, i_tr, i_te = load_series(
      data_root, dataset, series_id
  )
  if use_features:
    x_tr, x_te = featurize(x_tr, dataset), featurize(x_te, dataset)

  params = dict(GBOOST_PARAMS, n_estimators=n_estimators)
  start = time.time()
  models = {
      alpha: GradientBoostingRegressor(
          loss='quantile', alpha=alpha, **params
      ).fit(x_tr, y_tr)
      for alpha in (0.025, 0.5, 0.975)
  }
  runtime = time.time() - start
  rmse = float(np.sqrt(np.nanmean((y_te - models[0.5].predict(x_te)) ** 2)))

  x_all = np.concatenate([x_tr, x_te])
  yhat = models[0.5].predict(x_all)
  pred = pd.DataFrame(
      {
          'yhat': yhat,
          'yhat_std': np.zeros_like(yhat),
          'yhat_lower': models[0.025].predict(x_all),
          'yhat_upper': models[0.975].predict(x_all),
      },
      index=i_tr.append(i_te),
  )
  return _write_artifacts(
      output_dir,
      f'gboost-{n_estimators}-{use_features}.{dataset}.{series_id}',
      runtime, rmse, pred,
  )


def run_tsreg(
    data_root, dataset, series_id, output_dir, tsreg_method='OLS', **_,
):
  import scipy.stats
  import sklearn.linear_model

  x_tr, y_tr, x_te, y_te, i_tr, i_te = load_series(
      data_root, dataset, series_id
  )
  x_tr, x_te = featurize(x_tr, dataset), featurize(x_te, dataset)
  model = {
      'OLS': sklearn.linear_model.LinearRegression,
      'RIDGE': sklearn.linear_model.Ridge,
      'LASSO': sklearn.linear_model.Lasso,
  }[tsreg_method]()
  start = time.time()
  model.fit(x_tr, y_tr)
  runtime = time.time() - start

  rss = np.sum(np.square(model.predict(x_tr) - y_tr))
  dof = max(x_tr.shape[0] - x_tr.shape[1], 1)
  yhat_std = float(np.sqrt(rss / dof))
  rmse = float(np.sqrt(np.nanmean((y_te - model.predict(x_te)) ** 2)))

  x_all = np.concatenate([x_tr, x_te])
  yhat = model.predict(x_all)
  band = scipy.stats.norm(loc=yhat, scale=yhat_std)
  pred = pd.DataFrame(
      {
          'yhat': yhat,
          'yhat_std': np.full_like(yhat, yhat_std),
          'yhat_lower': band.ppf(0.025),
          'yhat_upper': band.ppf(0.975),
      },
      index=i_tr.append(i_te),
  )
  return _write_artifacts(
      output_dir, f'tsreg-{tsreg_method}.{dataset}.{series_id}',
      runtime, rmse, pred,
  )


def run_svgp(data_root, dataset, series_id, output_dir, num_z=2000, **kw):
  from bayesnf_torch.cli import baseline_gp

  return baseline_gp.run_svgp(
      data_root, dataset, series_id, output_dir, num_z=num_z,
      **baseline_gp.SVGP_CONFIG.get(dataset, {}), **kw,
  )


def run_st_svgp(data_root, dataset, series_id, output_dir, method='ST-SVGP',
                **kw):
  from bayesnf_torch.cli import baseline_gp

  cfg = dict(baseline_gp.ST_SVGP_CONFIG.get(dataset, {}))
  cfg.update(kw)
  return baseline_gp.run_st_svgp(
      data_root, dataset, series_id, output_dir, method=method, **cfg
  )


def run_nf(data_root, dataset, series_id, output_dir, **kw):
  from bayesnf_torch.cli import baseline_nf

  return baseline_nf.run_nf(data_root, dataset, series_id, output_dir, **kw)


METHODS = {
    'RF': run_rf,
    'GBOOST': run_gboost,
    'TSREG': run_tsreg,
    'SVGP': run_svgp,
    'ST-SVGP': run_st_svgp,
    'MF-ST-SVGP': functools.partial(run_st_svgp, method='MF-ST-SVGP'),
    'NF': run_nf,
}

# Python modules each method imports at run time (the heavy ones lazily).
# Target versions are pinned in requirements-baselines.txt at the repo root.
METHOD_DEPS = {
    'RF': ('sklearn',),
    'GBOOST': ('sklearn',),
    'TSREG': ('sklearn',),
    'SVGP': ('gpflow', 'tensorflow'),
    'ST-SVGP': ('bayesnewton', 'objax'),
    'MF-ST-SVGP': ('bayesnewton', 'objax'),
    'NF': ('neuralforecast',),
}


def probe_methods():
  """Per-method import probe: {'METHOD': 'OK' | 'SKIPPED (reason)'}.

  Lets a user check which of the 7 baseline methods are runnable in the
  current environment before launching anything (the heavy GP/NF deps are
  intentionally not dependencies of this package).
  """
  import importlib.util

  results = {}
  for method in sorted(METHODS):
    missing = [
        mod for mod in METHOD_DEPS[method]
        if importlib.util.find_spec(mod) is None
    ]
    if missing:
      results[method] = (
          f'SKIPPED (missing: {", ".join(missing)}; pip install -r '
          'requirements-baselines.txt)'
      )
    else:
      results[method] = 'OK'
  return results


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument(
      '--probe', action='store_true',
      help='report which methods are runnable here (import probe) and exit',
  )
  parser.add_argument('--data_root')
  parser.add_argument('--output_dir')
  parser.add_argument(
      '--dataset', choices=registry.runnable_datasets()
  )
  parser.add_argument(
      '--algorithm', choices=sorted(METHODS),
  )
  parser.add_argument('--start_id', type=int, default=5)
  parser.add_argument('--stop_id', type=int, default=None)
  parser.add_argument('--gboost_estimators', type=int, default=100)
  parser.add_argument('--gboost_featurize', action='store_true')
  parser.add_argument(
      '--tsreg_method', default='OLS', choices=['OLS', 'RIDGE', 'LASSO']
  )
  parser.add_argument('--svgp_num_z', type=int, default=2000)
  parser.add_argument('--nf_method', default='NBEATS')
  parser.add_argument('--nf_epochs', type=int, default=5000)
  parser.add_argument('--nf_window', type=int, default=5)
  args = parser.parse_args(argv)

  if args.probe:
    results = probe_methods()
    for method, status in results.items():
      print(f'{method:<11} {status}')
    return 0
  for required in ('data_root', 'output_dir', 'dataset', 'algorithm'):
    if getattr(args, required) is None:
      parser.error(f'--{required} is required (unless --probe)')

  runner = METHODS[args.algorithm]

  data_cfg = registry.dataset_config(args.dataset)
  stop_id = args.stop_id if args.stop_id is not None else data_cfg['num_series']
  for series_id in range(args.start_id, stop_id):
    sid = data_cfg['series_id_fmt'](series_id)
    print(f'{args.algorithm} {args.dataset} series {sid}')
    path = runner(
        args.data_root, args.dataset, sid, args.output_dir,
        n_estimators=args.gboost_estimators,
        use_features=args.gboost_featurize,
        tsreg_method=args.tsreg_method,
        num_z=args.svgp_num_z,
        nf_method=args.nf_method,
        nf_epochs=args.nf_epochs,
        nf_window=args.nf_window,
    )
    print(f'  -> {path}')


if __name__ == '__main__':
  main()
