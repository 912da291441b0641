"""Public estimator API: BayesianNeuralField{MAP,MLE,VI} (counterpart of
`bayesnf_tpu/spatiotemporal.py`).

Same constructor keywords and the same `bayesnf-tpu-estimator-v1` `.npz`
artifact as the JAX package, in both directions: an estimator fitted and
saved there loads here with `load(path, device)` and predicts on that
device; one fitted or saved here loads there. A VI artifact carries its
surrogate too, so a loaded VI estimator can `resample_posterior`.

What the port does, and what it does not yet:

- `fit` for MAP, MLE and VI with the NORMAL, NB or ZINB observation model,
  full batch or minibatch, on one device or over a `mesh`
  (`parallel/mesh.py`: members split over 'ens', rows over 'data'; in one
  process, or across ranks, `parallel/distributed.py`, every rank calling
  `fit` and `predict` alike and getting the whole results), on the
  'kernel' (CUDA) or 'torch' backend (`inference/map.py`,
  `inference/vi.py`), at `precision` 'f32', 'highest' (the same) or 'bf16'
  (`ops/mixed.py`); with a `checkpoint_dir` it saves in chunks and resumes
  bit for bit (`utils/checkpoint.py`, local directories only), and with
  `stream_chunk_steps` the table stays on the host and the batches stream
  to the device (`parallel/streaming.py`, `stream_member_remix` too).
- `predict` (means and exact mixture quantiles) and `likelihood_model` (the
  predictive distribution object of `models/distributions.py`), on the
  'kernel' or 'torch' backend (`inference/backends.py`), row-parallel over
  the fit's mesh (`mesh_`). They return tensors on the parameters' device;
  with `stream_chunk_rows` the table streams through the device in chunks
  of that many rows (`inference/predict_stream.py`) and they return CPU
  tensors, bit for bit the in-memory ones. `stream_cache_bytes` is
  accepted for the JAX package's signature and ignored: the streamed
  predict keeps no device cache.
- `params_` carries the JAX package's group shape: (mesh size, E / size)
  when the mesh's size divides E, else (1, E). `save` writes the mesh's
  extents as `fit_mesh`; `load` rebuilds the mesh when their product is the
  count of devices of the load device's type, and stays meshless
  otherwise, as the JAX package does; it never builds a mesh across
  processes.
"""

from collections.abc import Sequence
import json

import numpy as np
import torch

from bayesnf_torch.calendar import seasonalities_to_array
from bayesnf_torch.calendar import seasonality_to_float  # noqa: F401  (public)
from bayesnf_torch.data import SpatiotemporalDataHandler
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.inference import vi as vi_lib
from bayesnf_torch.models import distributions as dist_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods
from bayesnf_torch.parallel import mesh as mesh_lib
from bayesnf_torch.utils import profiling

ARTIFACT_FORMAT = 'bayesnf-tpu-estimator-v1'


def _group_shape(ensemble_size: int, mesh=None) -> tuple[int, int]:
  """The public (num_devices, per_device) factorization of the member axis:
  (mesh size, E / size) when the fit's mesh size divides E, else (1, E)."""
  num_devices = 1 if mesh is None else mesh.size
  if ensemble_size % num_devices == 0:
    return (num_devices, ensemble_size // num_devices)
  return (1, ensemble_size)


class BayesianNeuralFieldEstimator:
  """Base class for the estimators.

  Do not instantiate directly; use :class:`BayesianNeuralFieldMAP`,
  :class:`BayesianNeuralFieldMLE` or :class:`BayesianNeuralFieldVI`, or
  :meth:`load` a saved artifact.
  """

  _ensemble_dims: int
  _scale_epochs_by_batch_size = False

  def __init__(
      self,
      *,
      feature_cols: Sequence[str],
      target_col: str,
      seasonality_periods: Sequence[float | str] | None = None,
      num_seasonal_harmonics: Sequence[int] | None = None,
      fourier_degrees: Sequence[float] | None = None,
      interactions: Sequence[tuple[int, int]] | None = None,
      freq: str | None = None,
      timetype: str = 'index',
      depth: int = 2,
      width: int = 512,
      observation_model: str = 'NORMAL',
      standardize: Sequence[str] | None = None,
  ):
    """Shared initialization; keyword semantics match the JAX package.

    Args:
      feature_cols: column names; the first is the time variable.
      target_col: name of the target column.
      seasonality_periods: seasonal periods, as floats (multiples of `freq`)
        or pandas frequency aliases (with `timetype='index'`).
      num_seasonal_harmonics: harmonics per seasonal period
        (`timetype='index'` only).
      fourier_degrees: Fourier degree per feature column (default 5 each).
      interactions: pairs of feature-column indices to multiply.
      freq: pandas frequency alias of the data (iff `timetype='index'`).
      timetype: 'index' (datetime column) or 'float'.
      depth: hidden layers.
      width: hidden units per layer.
      observation_model: 'NORMAL' | 'NB' | 'ZINB'.
      standardize: columns to z-score with train stats (not the time column).
    """
    self.num_seasonal_harmonics = num_seasonal_harmonics
    self.seasonality_periods = seasonality_periods
    self.observation_model = observation_model
    self.depth = depth
    self.width = width
    self.feature_cols = feature_cols
    self.target_col = target_col
    self.timetype = timetype
    self.freq = freq
    self.fourier_degrees = fourier_degrees
    self.standardize = standardize
    self.interactions = interactions

    self.losses_ = None
    self.params_ = None
    self.surrogate_ = None
    self.mesh_ = None
    self.data_handler = SpatiotemporalDataHandler(
        self.feature_cols,
        self.target_col,
        self.timetype,
        self.freq,
        standardize=self.standardize,
    )

  # -- Hyperparameter resolution (as in the JAX package) ---------------------

  def _get_fourier_degrees(self, batch_shape) -> np.ndarray:
    if self.fourier_degrees is None:
      fourier_degrees = np.full(batch_shape[-1], 5, dtype=int)
    else:
      fourier_degrees = np.atleast_1d(self.fourier_degrees).astype(int)
      if fourier_degrees.shape[-1] != batch_shape[-1]:
        raise ValueError(
            f'Got {fourier_degrees.shape[-1]} fourier_degrees for '
            f'{batch_shape[-1]} feature columns; one degree per column is '
            'required.'
        )
    return fourier_degrees

  def _get_interactions(self) -> np.ndarray:
    if self.interactions is None:
      interactions = np.zeros((0, 2), dtype=int)
    else:
      interactions = np.array(self.interactions).astype(int)
      if np.ndim(interactions) != 2 or interactions.shape[-1] != 2:
        raise ValueError(
            '`interactions` must be a sequence of (i, j) feature-column '
            f'index pairs — an integer array of shape (N, 2); got shape '
            f'{interactions.shape}.'
        )
    return interactions

  def _get_seasonality_periods(self) -> np.ndarray:
    if (self.timetype == 'index' and self.freq is None) or (
        self.timetype == 'float' and self.freq is not None
    ):
      raise ValueError(f'Invalid freq={self.freq} with timetype={self.timetype}.')
    if self.seasonality_periods is None:
      return np.zeros(0)
    if self.timetype == 'index':
      return seasonalities_to_array(self.seasonality_periods, self.freq)
    if self.timetype == 'float':
      return np.asarray(self.seasonality_periods, dtype=float)
    raise AssertionError(f'Impossible timetype={self.timetype}.')

  def _get_num_seasonal_harmonics(self) -> np.ndarray:
    # Discrete time: harmonics are taken as given.
    if self.timetype == 'index':
      return (
          np.array(self.num_seasonal_harmonics)
          if self.num_seasonal_harmonics is not None
          else np.zeros(0)
      )
    # Continuous time: exactly one harmonic per seasonal factor; any value
    # in (0, min(.5, p/2)] yields the single base frequency.
    if self.timetype == 'float':
      if self.num_seasonal_harmonics is not None:
        raise ValueError(
            f'Cannot use num_seasonal_harmonics with timetype={self.timetype}.'
        )
      return np.fmin(0.5, self._get_seasonality_periods() / 2)
    raise AssertionError(f'Impossible timetype={self.timetype}.')

  def _field_config(self, batch_shape) -> field_lib.FieldConfig:
    return field_lib.FieldConfig.create(
        width=self.width,
        depth=self.depth,
        input_scales=self.data_handler.get_input_scales(),
        fourier_degrees=self._get_fourier_degrees(batch_shape),
        interactions=self._get_interactions(),
        seasonality_periods=self._get_seasonality_periods(),
        num_seasonal_harmonics=self._get_num_seasonal_harmonics(),
    )

  def _fit_inputs(self, table, batch_size, num_epochs, device, mesh,
                  host=False):
    """(config, aug features on `device`, or on the first device of
    `mesh`, or with `host` in host memory (`field.aug_features_host`, a
    streamed fit's), target, batch_size, num_epochs) of a fit: the batch
    is clamped to the table, and VI counts its epochs in steps (times N //
    batch_size), as the JAX package does."""
    device = (torch.device(device) if mesh is None
              else mesh_lib.check_mesh(mesh).first_device)
    if device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          f"Cannot fit on {device}: CUDA is not available (pass device='cpu' "
          'to fit on the CPU).'
      )
    train_data = self.data_handler.get_train(table)
    train_target = self.data_handler.get_target(table)
    n = train_data.shape[0]
    batch_size = n if batch_size is None else min(batch_size, n)
    if self._scale_epochs_by_batch_size:
      num_epochs = num_epochs * (n // batch_size)
    config = self._field_config((batch_size, train_data.shape[-1]))
    if host:
      aug = field_lib.aug_features_host(config, train_data)
    else:
      aug = field_lib.aug_features(
          config, torch.as_tensor(train_data, dtype=torch.float32,
                                  device=device))
    return config, aug, train_target, batch_size, num_epochs

  def _require_fitted(self, action: str) -> None:
    if self.params_ is None:
      raise ValueError(
          f'Cannot {action} an unfitted estimator; call fit first.'
      )

  # -- Prediction ------------------------------------------------------------

  def predict(self, table, quantiles=(0.5,), approximate_quantiles=False,
              backend='auto', stream_chunk_rows=None,
              stream_cache_bytes=None):
    """Predict the target at new field points.

    Args:
      table: DataFrame of new field locations (target column optional).
      quantiles: quantiles to compute.
      approximate_quantiles: moment-matching heuristic instead of
        root-finding.
      backend: 'auto' (the CUDA kernels when `params_` live on a CUDA
        device, plain PyTorch on the CPU) | 'torch' | 'kernel'.
      stream_chunk_rows: None (the table on the device at once), or the
        rows of a chunk of the streamed predict: the table stays on the
        host, device memory is O(chunk), and the results are CPU tensors,
        bit for bit the in-memory ones (the approximate quantiles to within
        rounding).
      stream_cache_bytes: accepted for the JAX package's signature and
        ignored (the streamed predict keeps no device cache).

    Returns:
      (means, quantiles) as tensors on the device of `params_` (streamed,
      the CPU): means has the ensemble leading dims `(num_devices,
      ensemble_size // num_devices, len(table))`; each quantile tensor has
      length `len(table)`. A fit
      over a mesh predicts over it too (row-parallel, `mesh_`).

    Raises:
      ValueError: if the estimator is unfitted.
    """
    self._require_fitted('predict with')
    with profiling.span('bnf.predict'):
      with profiling.span('bnf.predict.handler'):
        test_data = self.data_handler.get_test(table)
      return predict_lib.predict_bnf(
          test_data,
          self.observation_model,
          params=self.params_,
          config=self._field_config(test_data.shape),
          quantiles=quantiles,
          ensemble_dims=self._ensemble_dims,
          approximate_quantiles=approximate_quantiles,
          backend=backend,
          mesh=self.mesh_,
          stream_chunk_rows=stream_chunk_rows,
          stream_cache_bytes=stream_cache_bytes,
      )

  def likelihood_model(self, table, backend='auto', stream_chunk_rows=None,
                       stream_cache_bytes=None):
    """Predictive distribution object over the target at new points.

    Args:
      table: DataFrame of new field locations (target column optional).
      backend: 'auto' | 'torch' | 'kernel', as for :meth:`predict`.
      stream_chunk_rows: as for :meth:`predict`: streamed, the parameters
        are CPU tensors.
      stream_cache_bytes: as for :meth:`predict`.

    Returns:
      An `Independent` (`models/distributions.py`) over the rows, wrapping
      a `Normal` or the count distribution of `count_obs_dist`, whose
      parameters carry the ensemble axes of `params_` and live on their
      device (streamed, the CPU).

    Raises:
      ValueError: if the estimator is unfitted.
    """
    self._require_fitted('build the likelihood model of')
    test_data = self.data_handler.get_test(table)
    fp = predict_lib.forecast_params_bnf(
        test_data,
        self.observation_model,
        self.params_,
        self._field_config(test_data.shape),
        ensemble_dims=self._ensemble_dims,
        backend=backend,
        mesh=self.mesh_,
        stream_chunk_rows=stream_chunk_rows,
        stream_cache_bytes=stream_cache_bytes,
    )
    if likelihoods.LikelihoodDist(self.observation_model) == (
        likelihoods.LikelihoodDist.NORMAL):
      loc, scale = fp
      base = dist_lib.Normal(loc, scale[..., None])
    else:
      base = dist_lib.count_obs_dist(*fp)
    return dist_lib.Independent(base, 1)

  # -- Fitted-model persistence (serving) ------------------------------------

  def save(self, path: str) -> None:
    """Persist this fitted estimator to `path` (.npz).

    Writes the JAX package's artifact format: constructor arguments, the
    data handler's train-time statistics, `params_`, `losses_` and the fit
    mesh's extents (`fit_mesh`).
    """
    self._require_fitted('save')
    h = self.data_handler

    def jsonable(v):
      if isinstance(v, np.ndarray):
        return v.tolist()
      if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
      if isinstance(v, np.integer):
        return int(v)
      if isinstance(v, np.floating):
        return float(v)
      return v

    spec = {
        'format': ARTIFACT_FORMAT,
        'class': type(self).__name__,
        'kwargs': {
            'feature_cols': list(self.feature_cols),
            'target_col': self.target_col,
            'seasonality_periods': jsonable(self.seasonality_periods),
            'num_seasonal_harmonics': jsonable(self.num_seasonal_harmonics),
            'fourier_degrees': jsonable(self.fourier_degrees),
            'interactions': jsonable(self.interactions),
            'freq': self.freq,
            'timetype': self.timetype,
            'depth': int(self.depth),
            'width': int(self.width),
            'observation_model': self.observation_model,
            'standardize': jsonable(self.standardize),
        },
        'handler': {
            'mu': jsonable(h.mu_),
            'std': jsonable(h.std_),
            'time_min': jsonable(h.time_min_),
            'time_scale': jsonable(h.time_scale_),
        },
        'num_params': len(self.params_),
        'fit_mesh': None if self.mesh_ is None else dict(self.mesh_.shape),
    }
    arrays = {
        f'param_{i}': torch.as_tensor(p).detach().cpu().numpy()
        for i, p in enumerate(self.params_)
    }
    if self.losses_ is not None:
      arrays['losses'] = np.asarray(self.losses_)
    if self.surrogate_ is not None:
      # VI: the fitted surrogate, so that a loaded estimator can draw a
      # fresh posterior ensemble (`resample_posterior`).
      locs, raw_scales = self.surrogate_
      spec['num_surrogate_leaves'] = len(locs)
      for i, (loc, rs) in enumerate(zip(locs, raw_scales)):
        arrays[f'surrogate_loc_{i}'] = loc.detach().cpu().numpy()
        arrays[f'surrogate_raw_scale_{i}'] = rs.detach().cpu().numpy()
    # Write through a file object: np.savez(path) would append '.npz'.
    with open(path, 'wb') as f:
      np.savez(f, spec=np.asarray(json.dumps(spec)), **arrays)

  @classmethod
  def load(cls, path: str, device='cuda') -> 'BayesianNeuralFieldEstimator':
    """Reconstruct a fitted estimator saved with `save` by either package.

    Callable from the base class (the artifact names its concrete class) or
    from the matching subclass. The parameters go to `device`. An artifact
    fitted over a mesh of ens x data devices predicts over the mesh of
    `mesh.default_mesh` when `device`'s type has that many devices (every
    CUDA device, or the one CPU), and on `device` alone otherwise.

    Raises:
      RuntimeError: if `device` is CUDA and CUDA is not available.
      ValueError: if `path` is not an estimator artifact, holds another
        class than `cls`, or holds parameters of the wrong shapes.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          f'Cannot load onto {device}: CUDA is not available (pass '
          "device='cpu' to serve on the CPU)."
      )
    with np.load(path, allow_pickle=False) as data:
      spec = json.loads(str(data['spec']))
      if spec.get('format') != ARTIFACT_FORMAT:
        raise ValueError(f'Not a bayesnf-tpu estimator artifact: {path}')
      kwargs = spec['kwargs']
      classes = {
          c.__name__: c
          for c in (BayesianNeuralFieldMAP, BayesianNeuralFieldMLE,
                    BayesianNeuralFieldVI)
      }
      if spec['class'] not in classes:
        raise ValueError(f'Unknown estimator class {spec["class"]!r}.')
      target = classes[spec['class']]
      if cls is not BayesianNeuralFieldEstimator and cls is not target:
        raise ValueError(
            f'{path} holds a {spec["class"]}; load it via that class or the '
            'base BayesianNeuralFieldEstimator.'
        )
      model = target(**kwargs)
      h = model.data_handler
      hs = spec['handler']
      h.mu_ = np.asarray(hs['mu'], dtype=float)
      h.std_ = np.asarray(hs['std'], dtype=float)
      h.time_min_ = hs['time_min']
      h.time_scale_ = hs['time_scale']
      config = model._field_config((1, len(model.feature_cols)))
      model.params_ = field_lib.params_from_numpy(
          config,
          [data[f'param_{i}'] for i in range(spec['num_params'])],
          model._ensemble_dims,
          device,
      )
      model.losses_ = data['losses'] if 'losses' in data else None
      num_surrogate = spec.get('num_surrogate_leaves')
      if num_surrogate:
        model.surrogate_ = tuple(
            field_lib.params_from_numpy(
                config, [data[f'surrogate_{kind}_{i}']
                         for i in range(num_surrogate)], 1, device)
            for kind in ('loc', 'raw_scale'))
    fit_mesh = spec.get('fit_mesh')
    if fit_mesh:
      ens = int(fit_mesh.get(mesh_lib.ENSEMBLE_AXIS, 1))
      dat = int(fit_mesh.get(mesh_lib.DATA_AXIS, 1))
      if device.type == 'cuda' and ens * dat == torch.cuda.device_count():
        model.mesh_ = mesh_lib.default_mesh(None, ens, dat)
      elif device.type != 'cuda' and ens * dat == 1:
        model.mesh_ = mesh_lib.default_mesh([device], ens, dat)
    return model


class BayesianNeuralFieldMAP(BayesianNeuralFieldEstimator):
  """Stochastic ensembles of maximum-a-posteriori estimates."""

  _ensemble_dims = 2
  _prior_weight = 1.0

  def fit(
      self,
      table,
      seed: int,
      ensemble_size=16,
      learning_rate=0.005,
      num_epochs=5_000,
      batch_size=None,
      num_splits=1,
      backend='auto',
      device='cuda',
      precision='f32',
      mesh=None,
      checkpoint_dir=None,
      checkpoint_every=None,
      stream_chunk_steps=None,
      stream_member_remix=False,
  ) -> 'BayesianNeuralFieldMAP':
    """Run stochastic ensemble MAP (or MLE) inference.

    Args:
      table: training DataFrame (feature and target columns).
      seed: int seed of the initialization and of the minibatch
        permutations (split i of several uses `map.split_seed(seed, i,
        num_splits)`).
      ensemble_size: number of members.
      learning_rate: Adam learning rate.
      num_epochs: full passes over the table.
      batch_size: rows per step; None is the full batch. Each epoch takes
        `len(table) // batch_size` steps (the ragged tail is dropped).
      num_splits: sequential ensemble splits.
      backend: 'auto' (the CUDA kernel K1 on a CUDA device, plain PyTorch
        on the CPU) | 'torch' | 'kernel'.
      device: where the fit runs and `params_` live, without a mesh.
      precision: 'f32' (true fp32 products) | 'highest' (the same, bit for
        bit) | 'bf16' (bf16-rounded operands, exact products, fp32 sums;
        parameters, Adam and the elementwise math stay fp32), as the JAX
        package's argument (`ops/mixed.py`).
      mesh: None, or a `parallel.mesh.Mesh` (`mesh.default_mesh`; a device
        may repeat) to fit over: members split over 'ens' (padded to a
        multiple of its extent), rows over 'data' (`inference/map.py`).
        `params_` then live on its first device, and `predict` runs over it.
        A mesh across ranks (`parallel/distributed.py`) takes the same call
        on every rank, and each gets the whole `params_` and `losses_`.
      checkpoint_dir: None, or a local directory: the fit saves its state
        every `checkpoint_every` epochs (split i of several into
        `split_{i}` there), and a fit started on a directory that holds a
        save of the same configuration resumes from it, bit for bit the
        uninterrupted fit (`utils/checkpoint.py`).
      checkpoint_every: epochs between saves (default num_epochs // 10).
      stream_chunk_steps: None, or (with batch_size < len(table)) the
        table's rows stay in host memory and each epoch's batches, drawn
        from one permutation shared by every member, go to the device in
        slices of this many steps (`parallel/streaming.py`).
      stream_member_remix: (streaming only) each member remixes each
        slice's rows into its own batches; `stream_chunk_steps` is then
        the remix window.

    Returns:
      self, with `params_` leaves (g, ensemble_size / g, ...) and `losses_`
      (g, ensemble_size / g, num_epochs) as numpy, g the mesh's size when
      it divides ensemble_size, else 1.

    Raises:
      TypeError: if `mesh` is not a `parallel.mesh.Mesh`.
      ValueError: for an unknown precision, a minibatch on 'kernel' that
        does not split evenly over the mesh's data shards, streaming
        arguments the JAX package refuses (`map.check_supported`),
        or a `checkpoint_dir` that is a remote URI or holds another fit.
      RuntimeError: if `device` is CUDA and CUDA is not available.
    """
    config, aug, train_target, batch_size, num_epochs = self._fit_inputs(
        table, batch_size, num_epochs, device, mesh,
        host=stream_chunk_steps is not None)
    params, losses = map_lib.fit_map(
        aug, train_target, seed=seed,
        observation_model=self.observation_model, config=config,
        num_particles=ensemble_size, learning_rate=learning_rate,
        num_epochs=num_epochs, prior_weight=self._prior_weight,
        batch_size=batch_size, num_splits=num_splits, backend=backend,
        device=device, precision=precision, mesh=mesh,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        stream_chunk_steps=stream_chunk_steps,
        stream_member_remix=stream_member_remix,
    )
    g, m = _group_shape(ensemble_size, mesh)
    self.params_ = tuple(p.reshape((g, m) + tuple(p.shape[1:]))
                         for p in params)
    self.losses_ = losses.reshape((g, m) + losses.shape[1:])
    self.mesh_ = mesh
    return self


class BayesianNeuralFieldMLE(BayesianNeuralFieldMAP):
  """Stochastic ensembles of maximum likelihood estimates."""

  _prior_weight = 0.0


def _posterior_params(draws, ensemble_size, num_samples, mesh):
  """Draws (M, S, ...) in the public (g, S, M / g, ...) layout
  (`_group_shape`): the JAX package's reshape to (g, M / g, S) then swap of
  axes 1 and 2."""
  g, m = _group_shape(ensemble_size, mesh)
  return tuple(
      p.reshape((g, m, num_samples) + tuple(p.shape[2:]))
      .transpose(1, 2).contiguous() for p in draws)


class BayesianNeuralFieldVI(BayesianNeuralFieldEstimator):
  """Ensembles of mean-field surrogate posteriors via VI."""

  _ensemble_dims = 3
  _scale_epochs_by_batch_size = True

  def fit(
      self,
      table,
      seed: int,
      ensemble_size=16,
      learning_rate=0.01,
      num_epochs=1_000,
      sample_size_posterior=30,
      sample_size_divergence=5,
      kl_weight=0.1,
      batch_size=None,
      backend='auto',
      device='cuda',
      precision='f32',
      mesh=None,
      checkpoint_dir=None,
      checkpoint_every=None,
      stream_chunk_steps=None,
      stream_member_remix=False,
  ) -> 'BayesianNeuralFieldVI':
    """Run stochastic ensemble variational inference.

    Args:
      table: training DataFrame (feature and target columns).
      seed: int seed of the surrogate init (drawn as MAP's members are) and
        of the per-step draws and batches.
      ensemble_size: number of surrogate posteriors.
      learning_rate: Adam learning rate.
      num_epochs: epochs; the fit takes num_epochs * (len(table) //
        batch_size) steps, each on a freshly drawn batch per member.
      sample_size_posterior: parameter draws per surrogate for `params_`.
      sample_size_divergence: Monte-Carlo draws per ELBO estimate.
      kl_weight: weight of KL(q || prior) in the ELBO.
      batch_size: rows per step; None is the full batch.
      backend: 'auto' (the CUDA kernel K1 on a CUDA device, plain PyTorch
        on the CPU) | 'torch' | 'kernel'.
      device: where the fit runs and `params_` live, without a mesh.
      precision: as for :meth:`BayesianNeuralFieldMAP.fit`.
      mesh: as for :meth:`BayesianNeuralFieldMAP.fit`; every data shard of
        an ensemble group sees the same Monte-Carlo draws.
      checkpoint_dir: as for :meth:`BayesianNeuralFieldMAP.fit`; a save
        also holds the state of the generator of the noise, batches and
        posterior draws, so a resumed fit's `params_` are the
        uninterrupted fit's too.
      checkpoint_every: steps between saves (default steps // 10).
      stream_chunk_steps: as for :meth:`BayesianNeuralFieldMAP.fit`, but
        each step draws a fresh batch of rows, shared by every surrogate.
      stream_member_remix: as for :meth:`BayesianNeuralFieldMAP.fit`.

    Returns:
      self, with `surrogate_` (locs, raw_scales) of leaves (ensemble_size,
      ...), `params_` of leaves (g, sample_size_posterior, ensemble_size /
      g, ...) (g as for MAP) and `losses_` (g, ensemble_size / g, steps) as
      numpy.

    Raises:
      As :meth:`BayesianNeuralFieldMAP.fit`.
    """
    config, aug, train_target, batch_size, num_epochs = self._fit_inputs(
        table, batch_size, num_epochs, device, mesh,
        host=stream_chunk_steps is not None)
    surrogate, losses, draws = vi_lib.fit_vi(
        aug, train_target, seed=seed,
        observation_model=self.observation_model, config=config,
        ensemble_size=ensemble_size, learning_rate=learning_rate,
        num_epochs=num_epochs, sample_size_divergence=sample_size_divergence,
        sample_size_posterior=sample_size_posterior, kl_weight=kl_weight,
        batch_size=batch_size, backend=backend, device=device,
        precision=precision, mesh=mesh, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        stream_chunk_steps=stream_chunk_steps,
        stream_member_remix=stream_member_remix,
    )
    self.surrogate_ = surrogate
    self.params_ = _posterior_params(draws, ensemble_size,
                                     int(sample_size_posterior), mesh)
    g, m = _group_shape(ensemble_size, mesh)
    self.losses_ = losses.reshape((g, m) + losses.shape[1:])
    self.mesh_ = mesh
    return self

  def resample_posterior(self, seed: int, sample_size_posterior: int = 30):
    """Rebind `params_` to fresh draws from the fitted surrogate.

    Works on a loaded estimator too (`save` keeps the surrogate). The
    draws come from a generator on the surrogate's device seeded with
    `seed`; `params_` keeps its (g, S, M / g, ...) layout.

    Raises:
      ValueError: if there is no fitted surrogate.
    """
    if self.surrogate_ is None:
      raise ValueError(
          'No fitted surrogate: call fit first (or load an artifact saved '
          'from a fitted VI estimator).'
      )
    locs = self.surrogate_[0]
    generator = torch.Generator(device=locs[0].device).manual_seed(int(seed))
    config = self._field_config((1, len(self.feature_cols)))
    draws = vi_lib.posterior_draws(
        config, self.surrogate_, int(sample_size_posterior), generator)
    self.params_ = _posterior_params(draws, int(locs[0].shape[0]),
                                     int(sample_size_posterior), self.mesh_)
    return self
