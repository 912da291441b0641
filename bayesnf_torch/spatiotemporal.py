"""Public estimator API for serving: BayesianNeuralField{MAP,MLE}
(counterpart of `bayesnf_tpu/spatiotemporal.py`).

Same constructor keywords and the same `bayesnf-tpu-estimator-v1` `.npz`
artifact as the JAX package, in both directions: an estimator fitted and
saved there loads here with `load(path, device)` and predicts on that
device; one saved here loads there.

What this slice serves, and what it does not yet:

- `predict` for the NORMAL observation model, on the 'kernel' (CUDA) or
  'torch' backend (`inference/backends.py`). It returns tensors on the
  parameters' device.
- `fit` and `likelihood_model` raise NotImplementedError, and so does
  loading a VI, NB or ZINB artifact (ROADMAP.md, queue 1).
- The port runs on one device: the artifact's `fit_mesh` is read and
  ignored.
"""

from collections.abc import Sequence
import json

import numpy as np
import torch

from bayesnf_torch.calendar import seasonalities_to_array
from bayesnf_torch.data import SpatiotemporalDataHandler
from bayesnf_torch.inference import predict as predict_lib
from bayesnf_torch.models import field as field_lib

ARTIFACT_FORMAT = 'bayesnf-tpu-estimator-v1'


class BayesianNeuralFieldEstimator:
  """Base class for the estimators.

  Do not instantiate directly; use :class:`BayesianNeuralFieldMAP` or
  :class:`BayesianNeuralFieldMLE`, or :meth:`load` a saved artifact.
  """

  _ensemble_dims: int

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

  def _require_fitted(self, action: str) -> None:
    if self.params_ is None:
      raise ValueError(
          f'Cannot {action} an unfitted estimator; call fit first.'
      )

  # -- Prediction ------------------------------------------------------------

  def predict(self, table, quantiles=(0.5,), approximate_quantiles=False,
              backend='auto'):
    """Predict the target at new field points.

    Args:
      table: DataFrame of new field locations (target column optional).
      quantiles: quantiles to compute.
      approximate_quantiles: moment-matching heuristic instead of
        root-finding.
      backend: 'auto' (the CUDA kernels when `params_` live on a CUDA
        device, plain PyTorch on the CPU) | 'torch' | 'kernel'.

    Returns:
      (means, quantiles) as tensors on the device of `params_`: means has
      the ensemble leading dims `(num_devices, ensemble_size // num_devices,
      len(table))`; each quantile tensor has length `len(table)`.

    Raises:
      ValueError: if the estimator is unfitted.
    """
    self._require_fitted('predict with')
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
    )

  def fit(self, table, seed, **kwargs):
    raise NotImplementedError(
        'Training is not ported to PyTorch yet (ROADMAP.md, queue 1 item 7); '
        'fit with bayesnf_tpu, save, and load the artifact here.'
    )

  def likelihood_model(self, table, backend='auto'):
    raise NotImplementedError(
        'likelihood_model is not ported to PyTorch yet (ROADMAP.md, queue 1 '
        'items 4 and 8).'
    )

  # -- Fitted-model persistence (serving) ------------------------------------

  def save(self, path: str) -> None:
    """Persist this fitted estimator to `path` (.npz).

    Writes the JAX package's artifact format: constructor arguments, the
    data handler's train-time statistics, `params_` and `losses_`.
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
        'fit_mesh': None,
    }
    arrays = {
        f'param_{i}': torch.as_tensor(p).detach().cpu().numpy()
        for i, p in enumerate(self.params_)
    }
    if self.losses_ is not None:
      arrays['losses'] = np.asarray(self.losses_)
    # Write through a file object: np.savez(path) would append '.npz'.
    with open(path, 'wb') as f:
      np.savez(f, spec=np.asarray(json.dumps(spec)), **arrays)

  @classmethod
  def load(cls, path: str, device='cuda') -> 'BayesianNeuralFieldEstimator':
    """Reconstruct a fitted estimator saved with `save` by either package.

    Callable from the base class (the artifact names its concrete class) or
    from the matching subclass. The parameters go to `device`.

    Raises:
      RuntimeError: if `device` is CUDA and CUDA is not available.
      ValueError: if `path` is not an estimator artifact, holds another
        class than `cls`, or holds parameters of the wrong shapes.
      NotImplementedError: for a VI, NB or ZINB artifact.
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
      if spec['class'] == 'BayesianNeuralFieldVI':
        raise NotImplementedError(
            'VI estimators are not ported to PyTorch yet (ROADMAP.md, queue '
            '1 item 11).'
        )
      if kwargs.get('observation_model', 'NORMAL') != 'NORMAL':
        raise NotImplementedError(
            f'The {kwargs["observation_model"]} observation model is not '
            'ported to PyTorch yet (ROADMAP.md, queue 1 item 10).'
        )
      classes = {
          c.__name__: c
          for c in (BayesianNeuralFieldMAP, BayesianNeuralFieldMLE)
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
    return model


class BayesianNeuralFieldMAP(BayesianNeuralFieldEstimator):
  """Stochastic ensembles of maximum-a-posteriori estimates."""

  _ensemble_dims = 2


class BayesianNeuralFieldMLE(BayesianNeuralFieldMAP):
  """Stochastic ensembles of maximum likelihood estimates."""
