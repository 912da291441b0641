"""NeuralForecast (NBEATS et al.) baseline driver (counterpart of
`bayesnf_tpu/cli/baseline_nf.py`, a copy on the port's registry and data
handler).

Behavior parity with `run_experiment_neuralforecast`
(the reference's `scripts/evaluate_baseline.py:1101-1257`): per-location
forecast horizons, static (spatial) + dynamic + calendar-derived exogenous
features, multi-quantile loss at the 95% level, and the same
`nf-{method}.{dataset}.{series}.{log,pred}.csv` artifacts.

The neuralforecast/torch dependencies import lazily inside the runner, so
the driver — and its unit-testable data plumbing (`forecast_horizon`,
`make_nf_frames`) — exists without them.
"""

import importlib
import os
import time

import numpy as np
import pandas as pd

from bayesnf_torch.cli import registry

# Calendar features attached as dynamic exogenous covariates, per dataset
# (reference evaluate_baseline.py:189-203).
NF_SEASONAL_FEATURES = {
    'chickenpox': ['day', 'month', 'year'],
    'wind': ['day_of_week', 'day_of_year', 'day', 'month', 'year'],
    'air': ['day_of_week', 'day_of_year', 'day', 'month', 'year'],
    'air_quality': [
        'hour', 'day_of_week', 'day_of_year', 'day', 'month', 'year',
    ],
    'coprecip': ['day_of_week', 'day_of_year', 'day', 'month', 'year'],
    'sst': ['month', 'year'],
}


def _load_index_frames(data_root, dataset, series_id):
  """Train/test frames with integer period-index time, estimator-style."""
  from bayesnf_torch.data import SpatiotemporalDataHandler

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
      standardize=None,  # NF consumes raw integer time + raw covariates.
  )
  x_train = handler.get_train(df_train)
  y_train = handler.get_target(df_train)
  x_test = handler.get_test(handler.copy_and_filter_table(df_test))
  y_test = handler.get_target(df_test)
  df_train = handler.copy_and_filter_table(df_train)
  df_test = handler.copy_and_filter_table(df_test)
  return cfg, df_train, df_test, x_train, y_train, x_test, y_test


def forecast_horizon(df_train, df_test, t_train, t_test):
  """Max per-location gap between last train and last test time step.

  NeuralForecast predicts a fixed horizon past each series' end; the
  harness needs the largest such gap across locations (reference
  evaluate_baseline.py:1135-1147).
  """
  tr = df_train.copy()
  te = df_test.copy()
  tr['ds_int'] = np.asarray(t_train, dtype=np.float64)
  te['ds_int'] = np.asarray(t_test, dtype=np.float64)
  t_max_train = tr.groupby('location')['ds_int'].max()
  t_max_test = te.groupby('location')['ds_int'].max()
  horizon = (t_max_test - t_max_train.loc[t_max_test.index]).max()
  assert horizon == int(horizon), horizon
  return int(horizon)


def make_nf_frames(dataset, cfg, df_train, df_test, x_train, y_train, x_test,
                   y_test):
  """(train_df, test_df, static_df, futr_exog_list) in NeuralForecast layout.

  Long-format frames keyed by (unique_id=location, ds=integer time) with
  the dataset's trailing feature columns and calendar fields as exogenous
  covariates; per-location static frame carries the spatial coordinates
  (reference evaluate_baseline.py:1149-1183).
  """
  feature_cols = cfg['feature_cols']
  static_features = feature_cols[1:3]
  dynamic_features = feature_cols[3:]
  seasonal_features = NF_SEASONAL_FEATURES[dataset]

  df_train = df_train.copy()
  df_test = df_test.copy()
  for sf in seasonal_features:
    df_train[sf] = np.float64(getattr(df_train.datetime.dt, sf))
    df_test[sf] = np.float64(getattr(df_test.datetime.dt, sf))

  def to_nf(df, x, y):
    out = pd.DataFrame({
        'unique_id': df['location'].values,
        'ds': np.int64(np.asarray(x)[:, 0]),
        'y': np.asarray(y, dtype=np.float64),
    })
    for f in dynamic_features + seasonal_features:
      out[f] = df[f].values
    return out

  nf_train = to_nf(df_train, x_train, y_train)
  nf_test = to_nf(df_test, x_test, y_test)
  static_df = (
      df_train.groupby('location')[static_features].max().reset_index()
  ).rename({'location': 'unique_id'}, axis=1)
  futr_exog = list(nf_train.columns[3:])
  return nf_train, nf_test, static_df, futr_exog


def run_nf(
    data_root,
    dataset,
    series_id,
    output_dir,
    *,
    nf_method='NBEATS',
    nf_epochs=5000,
    nf_window=5,
    **_,
):
  """Train a NeuralForecast model and emit the baseline artifact pair."""
  try:
    nf_models = importlib.import_module('neuralforecast.models')
    nf_auto = importlib.import_module('neuralforecast.auto')
    nf_core = importlib.import_module('neuralforecast')
    nf_losses = importlib.import_module('neuralforecast.losses.pytorch')
  except ImportError as e:
    raise SystemExit(
        f"Baseline 'NF' requires neuralforecast "
        f'(missing: {e.name}). Install it and re-run.'
    ) from e

  (cfg, df_train, df_test, x_train, y_train, x_test, y_test) = (
      _load_index_frames(data_root, dataset, series_id)
  )
  horizon = forecast_horizon(df_train, df_test, x_train[:, 0], x_test[:, 0])
  nf_train, nf_test, static_df, futr_exog = make_nf_frames(
      dataset, cfg, df_train, df_test, x_train, y_train, x_test, y_test
  )

  loss = nf_losses.MQLoss(level=[95])
  if hasattr(nf_models, nf_method):
    model = getattr(nf_models, nf_method)(
        input_size=nf_window * horizon,
        h=horizon,
        futr_exog_list=futr_exog,
        max_steps=nf_epochs,
        random_seed=int(series_id),
        loss=loss,
    )
  elif hasattr(nf_auto, nf_method):
    model = getattr(nf_auto, nf_method)(
        h=horizon,
        config=dict(
            input_size=nf_window * horizon,
            futr_exog_list=futr_exog,
            max_steps=nf_epochs,
            random_seed=int(series_id),
        ),
        loss=loss,
    )
  else:
    raise ValueError(f'Unknown NeuralForecast method: {nf_method!r}')

  nf = nf_core.NeuralForecast(models=[model], freq=1)
  start = time.time()
  nf.fit(nf_train, static_df=static_df)
  runtime = time.time() - start

  os.makedirs(output_dir, exist_ok=True)
  stem = f'nf-{nf_method.lower()}.{dataset}.{series_id}'
  pd.DataFrame(
      dict(epoch=[nf_epochs], runtime=[runtime], rmse=[np.nan], nlpd=[np.nan])
  ).to_csv(os.path.join(output_dir, f'{stem}.log.csv'), index=False)

  # Forecast over the test region: missing (id, ds) pairs are filled so
  # every location reaches its horizon, then predictions are joined back
  # onto the original test rows (reference evaluate_baseline.py:1225-1246).
  futr_df = pd.concat((nf_test, nf.get_missing_future(nf_test)))
  futr_df = futr_df.replace({float('nan'): 1})
  nf_pred = nf.predict(futr_df=futr_df)

  probe = df_test.copy()
  probe['ds_int'] = np.int64(x_test[:, 0])
  probe['ordering'] = np.arange(len(probe))
  merged = pd.merge(
      probe,
      nf_pred,
      left_on=['location', 'ds_int'],
      right_on=['unique_id', 'ds'],
  ).sort_values(by='ordering')
  assert np.all(merged.unique_id.values == probe.location.values)
  merged.index = df_test.index

  pred_df = pd.DataFrame(
      {
          'yhat': merged[f'{nf_method}-median'].values,
          'yhat_std': np.zeros(len(merged)),
          'yhat_lower': merged[f'{nf_method}-lo-95'].values,
          'yhat_upper': merged[f'{nf_method}-hi-95'].values,
      },
      index=merged.index,
  )
  pred_path = os.path.join(output_dir, f'{stem}.pred.csv')
  pred_df.to_csv(pred_path, index=True)
  return pred_path
