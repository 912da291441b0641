"""Gaussian-process baselines: GPflow SVGP and BayesNewton (MF-)ST-SVGP
(counterpart of `bayesnf_tpu/cli/baseline_gp.py`, a copy: it imports
nothing of either package).

Behavior parity with the reference drivers
(the reference's `scripts/evaluate_baseline.py:604-818` for SVGP,
`:410-597` for the BayesNewton state-space GPs, `:212-251` for the
spatiotemporal grid builder, `:255-340` for the tidy unix-time loader).

The heavy dependencies (gpflow + tensorflow, bayesnewton + objax) are
imported lazily inside the runners, so the drivers exist — and all their
data plumbing (grid construction, checkpoint schedule, probe-frame joins,
artifact schema) is unit-testable with mocked model objects — even in
environments where the libraries are absent. Artifacts:

- ``{method}.{dataset}.{series}.log.csv``  — epoch, runtime, rmse, nlpd
  (the state-space GPs log at power-of-2 step checkpoints, the SVGP about
  10x per epoch, matching the reference's cadence).
- ``{method}.{dataset}.{series}.pred.csv`` — yhat, yhat_std, yhat_lower,
  yhat_upper over train+test rows, indexed by the original row index.
"""

import importlib
import os
import time
import types

import numpy as np
import pandas as pd

# Dataset table for the GP baselines: unix-epoch time, z-scored features,
# raw targets (reference DATASET_CONFIG_BASELINE, evaluate_baseline.py:117-155).
DATASET_CONFIG_BASELINE = {
    'air_quality': dict(target_col='pm10'),
    'wind': dict(target_col='wind'),
    'air': dict(target_col='pm10'),
    'chickenpox': dict(target_col='chickenpox'),
    'coprecip': dict(target_col='ppt'),
    'sst': dict(target_col='sst', extra_features=('soi',)),
}

# Per-dataset (MF-)ST-SVGP settings (reference evaluate_baseline.py:157-176).
ST_SVGP_CONFIG = {
    'air_quality': dict(len_space=0.2),
    'wind': dict(len_space=0.2, sparse=False),
    'air': dict(len_space=0.2),
    'chickenpox': dict(len_space=0.2, sparse=False),
    'coprecip': dict(len_space=0.2, sparse=True, iters=500),
}

# SVGP inducing-point count -> minibatch size (reference :178-187).
SVGP_CONFIG = {
    'air_quality': dict(
        num_z_to_batch_size={
            1500: 400, 2000: 600, 2500: 800, 5000: 2000, 8000: 3000
        }
    ),
}


def load_series_tidy(data_root, dataset, series_id):
  """Tidy loader for the GP baselines: unix time + z-scored features.

  Matches the reference's `get_dataset_tidy(..., timetype='unix',
  standardize=<all feature cols>)` semantics (evaluate_baseline.py:255-340):
  the datetime column becomes float UNIX seconds, every feature column is
  standardized by train statistics, and targets stay raw (NaNs included —
  callers drop them per use).
  """
  cfg = DATASET_CONFIG_BASELINE[dataset]
  feature_cols = ['datetime', 'latitude', 'longitude'] + list(
      cfg.get('extra_features', ())
  )
  read = lambda split: pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.{split}.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )
  df_train, df_test = read('train'), read('test')

  def to_matrix(df):
    x = df[feature_cols].copy()
    x['datetime'] = x['datetime'].astype('int64') // int(1e9)
    return x.values.astype(np.float64)

  x_train, x_test = to_matrix(df_train), to_matrix(df_test)
  mu = x_train.mean(axis=0)
  std = x_train.std(axis=0)
  # Constant columns (e.g. a single-location series) z-score to ~0 instead
  # of exploding by a round-off-sized divisor (the reference loader would
  # produce huge or NaN values here).
  std[std <= 1e-10 * np.maximum(1.0, np.abs(mu))] = 1.0
  x_train = (x_train - mu) / std
  x_test = (x_test - mu) / std
  return types.SimpleNamespace(
      x_train=x_train,
      y_train=df_train[cfg['target_col']].values.astype(np.float64),
      x_test=x_test,
      y_test=df_test[cfg['target_col']].values.astype(np.float64),
      index_train=df_train.index.values,
      index_test=df_test.index.values,
      df_train=df_train,
      df_test=df_test,
  )


def drop_nan_targets(x, y):
  """Rows of (x, y) where y is observed."""
  keep = ~np.isnan(y)
  return x[keep], y[keep]


def create_spatiotemporal_grid(x, y):
  """Regrid scattered (time, space) observations onto a dense grid.

  Returns (t, R, Y): t (T, 1) unique sorted times; R (T, S, D_space) the
  spatial locations per time step (identical across t); Y (T, S, 1) the
  observations with NaN at (time, location) pairs that were never observed.

  Behavior matches the reference's generalization of BayesNewton's
  `create_spatiotemporal_grid` (evaluate_baseline.py:212-251; upstream
  https://github.com/AaltoML/BayesNewton bayesnewton/utils.py#L271): the
  dense grid is the cross product of unique times and unique locations,
  filled from the data with NaN padding.
  """
  y = np.asarray(y, dtype=np.float64).reshape(-1, 1)
  x = np.asarray(x, dtype=np.float64)
  num_space = x.shape[1] - 1

  order = np.lexsort([x[:, i] for i in range(num_space, -1, -1)])
  x, y = x[order], y[order]
  unique_time = np.unique(x[:, 0])
  unique_space = np.unique(x[:, 1:], axis=0)
  n_t, n_s = unique_time.shape[0], unique_space.shape[0]

  # Pad with one NaN row per (time, location) grid point; de-duplication
  # prefers the real observation (np.unique keeps the first index, and the
  # real rows are stacked first).
  pad_x = np.column_stack([
      np.repeat(unique_time, n_s)[:, None],
      np.tile(unique_space, (n_t, 1)),
  ])
  pad_y = np.full((n_t * n_s, 1), np.nan)
  x_all = np.vstack([x, pad_x])
  y_all = np.vstack([y, pad_y])
  x_grid, first = np.unique(x_all, axis=0, return_index=True)
  y_grid = y_all[first]

  r = x_grid[:, 1:].reshape(n_t, n_s, num_space)
  return unique_time[:, None], r, y_grid.reshape(n_t, n_s, 1)


def checkpoint_steps(iters):
  """Power-of-2 metric checkpoints: steps 1, 2, 4, ... plus the last.

  Matches the reference's `(c, ckpt) = (c+1, 2*ckpt)` logging cadence
  (evaluate_baseline.py:523-545); returned as 0-based step indices.
  """
  steps = []
  ckpt = 1
  while ckpt <= iters:
    steps.append(ckpt - 1)
    ckpt *= 2
  if steps[-1] != iters - 1:
    steps.append(iters - 1)
  return steps


def _write_artifacts(output_dir, stem, log_df, pred_df):
  os.makedirs(output_dir, exist_ok=True)
  log_path = os.path.join(output_dir, f'{stem}.log.csv')
  log_df.to_csv(log_path, index=False)
  pred_path = os.path.join(output_dir, f'{stem}.pred.csv')
  pred_df.to_csv(pred_path, index=True)
  return pred_path


def _probe_join(table, t_probe, r_probe, yhat, yhat_std):
  """Map grid-ordered predictions back to the original row index.

  The grid reorders (and densifies) the probe rows; joining the original
  (time, space) rows against the grid rows recovers per-original-row
  predictions (reference evaluate_baseline.py:560-597).
  """
  x_probe = np.concatenate([table.x_train, table.x_test])
  index_probe = np.concatenate([table.index_train, table.index_test])
  df_probe = pd.DataFrame(x_probe, index=index_probe)
  df_probe.index.name = '__index__'
  df_probe = df_probe.reset_index()

  import scipy.stats

  dist = scipy.stats.norm(loc=yhat, scale=yhat_std)
  grid_cols = np.column_stack([
      np.repeat(t_probe[:, 0], r_probe.shape[1])[:, None],
      r_probe.reshape(-1, r_probe.shape[-1]),
      yhat[:, None],
      yhat_std[:, None],
      dist.ppf(0.025)[:, None],
      dist.ppf(0.975)[:, None],
  ])
  df_grid = pd.DataFrame(grid_cols)
  feature_cols = list(df_probe.columns[1:])
  # m:1, not 1:1 — the probe table may legitimately repeat a (time, space)
  # coordinate (duplicate sensor readings); each copy joins the single
  # matching grid row. A duplicate on the GRID side would still raise.
  joined = pd.merge(
      df_probe, df_grid, on=feature_cols, how='left', validate='m:1'
  )
  joined = joined.set_index('__index__')
  joined.index.name = None
  joined = joined.drop(columns=feature_cols)
  joined.columns = ['yhat', 'yhat_std', 'yhat_lower', 'yhat_upper']
  return joined


def run_st_svgp(
    data_root,
    dataset,
    series_id,
    output_dir,
    *,
    method='ST-SVGP',
    parallel=True,
    sparse=True,
    lr_newton=1.0,
    lr_adam=0.01,
    len_time=0.001,
    len_space=0.2,
    num_z_space=30,
    var_y=5.0,
    iters=5000,
    **_,
):
  """BayesNewton spatiotemporal state-space SVGP (full or mean-field).

  Mirrors `run_experiment_bayesnewton` (reference :410-597): z-scored
  targets, dense (time x space) grid, Matern-3/2 temporal x separable
  spatial kernel with optional k-means inducing points, natural-gradient
  variational inference with Adam on the hyperparameters, power-of-2
  metric checkpoints, grid-join prediction artifact.
  """
  try:
    bayesnewton = importlib.import_module('bayesnewton')
    objax = importlib.import_module('objax')
  except ImportError as e:
    raise SystemExit(
        f'Baseline {method!r} requires bayesnewton + objax '
        f'(missing: {e.name}). Install them and re-run.'
    ) from e
  from scipy.cluster.vq import kmeans2

  assert method in ('ST-SVGP', 'MF-ST-SVGP')
  table = load_series_tidy(data_root, dataset, series_id)

  y_mu, y_std = np.nanmean(table.y_train), np.nanstd(table.y_train)
  t, r, y = create_spatiotemporal_grid(
      *drop_nan_targets(table.x_train, (table.y_train - y_mu) / y_std)
  )
  x_test_obs, y_test_obs = drop_nan_targets(table.x_test, table.y_test)
  t_test, r_test, y_test_grid = create_spatiotemporal_grid(
      x_test_obs, y_test_obs
  )
  y_test_norm = (y_test_grid - y_mu) / y_std

  z = kmeans2(r[0], num_z_space, minit='points')[0] if sparse else r[0]
  kern = bayesnewton.kernels.SpatioTemporalKernel(
      temporal_kernel=bayesnewton.kernels.Matern32(
          variance=1.0, lengthscale=len_time
      ),
      spatial_kernel=bayesnewton.kernels.Separable([
          bayesnewton.kernels.Matern32(variance=1.0, lengthscale=len_space),
          bayesnewton.kernels.Matern32(variance=1.0, lengthscale=len_space),
      ]),
      z=z,
      sparse=sparse,
      opt_z=sparse,
      conditional='Full',
  )
  constructor = {
      'ST-SVGP': bayesnewton.models.MarkovVariationalGP,
      'MF-ST-SVGP': bayesnewton.models.MarkovVariationalMeanFieldGP,
  }[method]
  model = constructor(
      kernel=kern,
      likelihood=bayesnewton.likelihoods.Gaussian(variance=var_y),
      X=t,
      R=r,
      Y=y,
      parallel=parallel,
  )

  opt_hypers = objax.optimizer.Adam(model.vars())
  energy = objax.GradValues(model.energy, model.vars())

  @objax.Function.with_vars(model.vars() + opt_hypers.vars())
  def train_op():
    model.inference(lr=lr_newton)  # natural-gradient variational update
    de, (e,) = energy()
    opt_hypers(lr_adam, de)
    return e

  train_op = objax.Jit(train_op)

  def metrics():
    mean, _ = model.predict_y(X=t_test, R=r_test)
    mean = np.asarray(mean) * y_std + y_mu
    rmse = float(np.sqrt(np.nanmean(
        np.square(mean.reshape(-1) - y_test_grid.reshape(-1))
    )))
    nlpd = float(model.negative_log_predictive_density(
        X=t_test, R=r_test, Y=y_test_norm
    ))
    return rmse, nlpd

  ckpts = set(checkpoint_steps(iters))
  rows = []
  elapsed = 0.0
  for i in range(iters):
    start = time.time()
    loss = train_op()
    elapsed += time.time() - start
    if i in ckpts:
      rmse, nlpd = metrics()
      rows.append(dict(epoch=i, runtime=elapsed, rmse=rmse, nlpd=nlpd,
                       loss=float(np.asarray(loss))))

  log_df = pd.DataFrame(rows)[['epoch', 'runtime', 'rmse', 'nlpd']]

  x_probe = np.concatenate([table.x_train, table.x_test])
  y_probe = np.concatenate([table.y_train, table.y_test])
  t_probe, r_probe, _ = create_spatiotemporal_grid(x_probe, y_probe)
  mean_f, var_f = model.predict_y(X=t_probe, R=r_probe)
  yhat = np.ravel(np.asarray(mean_f)) * y_std + y_mu
  yhat_std = np.sqrt(np.ravel(np.asarray(var_f))) * y_std
  pred_df = _probe_join(table, t_probe, r_probe, yhat, yhat_std)

  stem = f'bayesnewton-{method.lower()}.{dataset}.{series_id}'
  return _write_artifacts(output_dir, stem, log_df, pred_df)


def _cvi_init(kernel_fn, z, jitter=1e-6):
  """CVI-style q(u) initialization (reference :673-694).

  Builds the variational mean/Cholesky from the natural-parameter identity
  S = (-2 (nat2 + lam2))^-1, m = S (lam1 + nat1) with nat2 = -K_zz^-1 / 2.
  """
  import scipy.linalg

  m = z.shape[0]
  kzz = np.asarray(kernel_fn(z, z))

  def inv(k):
    chol = scipy.linalg.cholesky(k + jitter * np.eye(m), lower=True)
    return scipy.linalg.cho_solve((chol, True), np.eye(m))

  nat1 = np.zeros([m, 1])
  nat2 = -0.5 * inv(kzz)
  lam1 = 1e-5 * np.ones([m, 1])
  lam2 = -0.5 * np.eye(m)
  s = inv(-2 * (nat2 + lam2))
  q_mu = s @ (lam1 + nat1)
  s_chol = scipy.linalg.cholesky(s + jitter * np.eye(m), lower=True)
  return q_mu, np.array([s_chol])


def run_svgp(
    data_root,
    dataset,
    series_id,
    output_dir,
    *,
    num_z=2000,
    num_z_to_batch_size=None,
    kernel_lengthscales=(0.01, 0.2, 0.2),
    natgrad_step_size=1.0,
    likelihood_noise=5.0,
    epochs=300,
    step_size=0.01,
    **_,
):
  """GPflow sparse variational GP with natural-gradient q(u) updates.

  Mirrors `run_experiment_gpflow` (reference :604-818): product of per-dim
  Matern-3/2 kernels, k-means inducing points, CVI-compatible q(u) init,
  alternating natural-gradient (variational) and Adam (hyperparameter)
  minibatch steps, metrics ~10x per epoch. One deviation: the reference
  names its log file `*.csv` and then `.replace('.log.', '.pred.')`, so
  its predictions overwrite its log; here the log is written to `.log.csv`
  so both artifacts survive.
  """
  try:
    gpflow = importlib.import_module('gpflow')
    tf = importlib.import_module('tensorflow')
  except ImportError as e:
    raise SystemExit(
        f"Baseline 'SVGP' requires gpflow + tensorflow "
        f'(missing: {e.name}). Install them and re-run.'
    ) from e
  from scipy.cluster.vq import kmeans2

  table = load_series_tidy(data_root, dataset, series_id)
  x_train, y_train = drop_nan_targets(table.x_train, table.y_train)
  x_test, y_test = drop_nan_targets(table.x_test, table.y_test)
  y_train = y_train[:, None]
  y_test = y_test[:, None]

  batch_size = (num_z_to_batch_size or {}).get(num_z, min(2000, len(y_train)))
  n, d = x_train.shape
  z = kmeans2(x_train, num_z, minit='points')[0]

  kernel = None
  for dim in range(d):
    ls = (
        kernel_lengthscales[dim]
        if isinstance(kernel_lengthscales, (list, tuple))
        else kernel_lengthscales
    )
    k_d = gpflow.kernels.Matern32(
        lengthscales=[ls], variance=1.0, active_dims=[dim]
    )
    kernel = k_d if kernel is None else kernel * k_d

  q_mu, q_sqrt = _cvi_init(kernel, z)
  model = gpflow.models.SVGP(
      inducing_variable=z,
      whiten=True,
      kernel=kernel,
      mean_function=None,
      likelihood=gpflow.likelihoods.Gaussian(variance=likelihood_noise),
      q_mu=q_mu,
      q_sqrt=q_sqrt,
  )
  gpflow.utilities.set_trainable(model.inducing_variable, True)
  gpflow.utilities.set_trainable(model.q_mu, False)
  gpflow.utilities.set_trainable(model.q_sqrt, False)

  dataset_iter = iter(
      tf.data.Dataset.from_tensor_slices((x_train, y_train))
      .repeat()
      .shuffle(n)
      .batch(batch_size)
  )
  training_loss = model.training_loss_closure(dataset_iter, compile=True)
  natgrad = gpflow.optimizers.NaturalGradient(gamma=natgrad_step_size)
  adam = tf.optimizers.Adam(step_size)
  variational_params = [(model.q_mu, model.q_sqrt)]

  @tf.function
  def train_step():
    natgrad.minimize(training_loss, var_list=variational_params)
    adam.minimize(training_loss, var_list=model.trainable_variables)

  def predict(x, y):
    mu, var = model.predict_y(x)
    lpd = model.predict_log_density((x, y))
    return np.asarray(mu), np.asarray(var), np.asarray(lpd)

  niters = epochs * n // batch_size
  ckpt_every = max(1, n // (batch_size * 10))  # metrics ~10x per epoch
  rows = []
  t0 = time.time()
  metrics_time = 0.0
  for i in range(niters):
    train_step()
    if i % ckpt_every == 0 or i == niters - 1:
      mt0 = time.time()
      mean, _, lpd = predict(x_test, y_test)
      rows.append(dict(
          epoch=(i + 1) * batch_size / n,
          runtime=time.time() - t0 - metrics_time,
          rmse=float(np.sqrt(np.nanmean(
              (y_test.ravel() - mean.ravel()) ** 2
          ))),
          nlpd=float(-np.mean(lpd)),
      ))
      metrics_time += time.time() - mt0

  log_df = pd.DataFrame(rows)[['epoch', 'runtime', 'rmse', 'nlpd']]

  x_probe = np.concatenate([table.x_train, table.x_test])
  y_probe = np.concatenate([table.y_train, table.y_test])[:, None]
  yhat, yvar, _ = predict(x_probe, np.nan_to_num(y_probe))
  yhat = yhat.ravel()
  yhat_std = np.sqrt(yvar).ravel()

  import scipy.stats

  dist = scipy.stats.norm(loc=yhat, scale=yhat_std)
  pred_df = pd.DataFrame(
      {
          'yhat': yhat,
          'yhat_std': yhat_std,
          'yhat_lower': dist.ppf(0.025),
          'yhat_upper': dist.ppf(0.975),
      },
      index=np.concatenate([table.index_train, table.index_test]),
  ).sort_index()

  stem = f'gpflow-svgp-{num_z}-{batch_size}.{dataset}.{series_id}'
  return _write_artifacts(output_dir, stem, log_df, pred_df)
