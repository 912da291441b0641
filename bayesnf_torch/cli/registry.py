"""Dataset / model / inference registry for the paper experiment suite.

One nested table per dataset, merging what the reference splits across
`scripts/dataset_config.py` (DATASET_CONFIG + MODEL_CONFIG) and
`scripts/evaluate.py:194-307` (INFERENCE_CONFIG). Values reproduce the
published experiment configurations so runs are comparable one-to-one.

A verbatim copy of `bayesnf_tpu/cli/registry.py` (this docstring aside):
that module imports only numpy, but importing it runs
`bayesnf_tpu/__init__.py`, which imports JAX. `tests/test_torch_cli.py`
holds the two tables equal.
"""

import numpy as np


def _dataset(
    *,
    target_col,
    freq,
    feature_cols=('datetime', 'latitude', 'longitude'),
    standardize=('latitude', 'longitude'),
    num_series=10,
):
  return {
      'num_series': num_series,
      'target_col': target_col,
      'timetype': 'index',
      'freq': freq,
      'feature_cols': list(feature_cols),
      'standardize': list(standardize),
      'series_id_fmt': str,
  }


def _model(width, seasonality_periods, num_seasonal_harmonics, depth=2):
  return {
      'width': width,
      'depth': depth,
      'seasonality_periods': np.asarray(seasonality_periods),
      'num_seasonal_harmonics': np.asarray(num_seasonal_harmonics),
      'observation_model': 'NORMAL',
  }


REGISTRY = {
    'air_quality': {
        'data': _dataset(target_col='pm10', freq='h'),
        'model': {
            'map': _model(512, [24, 24 * 7], [4, 4]),
        },
        'inference': {
            'map': dict(num_particles=16, num_epochs=4000,
                        learning_rate=0.005, batch_size=38096),
            'vi': dict(num_particles=16, num_epochs=500, learning_rate=0.01,
                       batch_size=3500, kl_weight=0.2,
                       sample_size_divergence=5),
        },
    },
    'wind': {
        'data': _dataset(target_col='wind', freq='D'),
        'model': {
            'map': _model(512, [7, 365.25 / 12, 365.25], [3, 10, 10]),
        },
        'inference': {
            'map': dict(num_particles=64, num_epochs=10000,
                        learning_rate=0.005),
            'vi': dict(num_particles=64, num_epochs=2000, learning_rate=0.01,
                       batch_size=3944, kl_weight=0.1,
                       sample_size_divergence=5),
        },
    },
    'air': {
        'data': _dataset(target_col='pm10', freq='D'),
        'model': {
            'map': _model(512, [7, 365.25 / 12, 365.25], [3, 10, 10]),
        },
        'inference': {
            'map': dict(num_particles=8, num_epochs=7500,
                        learning_rate=0.005),
            'vi': dict(num_particles=8, num_epochs=1000, learning_rate=0.01,
                       batch_size=3800, kl_weight=0.2,
                       sample_size_divergence=5),
        },
    },
    'chickenpox': {
        'data': _dataset(target_col='chickenpox', freq='W'),
        'model': {
            'map': _model(256, [4.0, 52.1775], [2.0, 10]),
        },
        'inference': {
            'map': dict(num_particles=64, num_epochs=10000,
                        learning_rate=0.005),
            'vi': dict(num_particles=64, num_epochs=1000, learning_rate=0.01,
                       batch_size=511, kl_weight=0.1,
                       sample_size_divergence=5),
        },
    },
    'coprecip': {
        'data': _dataset(target_col='ppt', freq='M'),
        'model': {
            'map': _model(512, [12], [6]),
        },
        'inference': {
            'map': dict(num_particles=16, num_epochs=7500,
                        learning_rate=0.005),
            'vi': dict(num_particles=16, num_epochs=750, learning_rate=0.01,
                       batch_size=3300, kl_weight=0.2,
                       sample_size_divergence=5),
        },
    },
    'sst': {
        'data': _dataset(
            target_col='sst',
            freq='M',
            feature_cols=('datetime', 'latitude', 'longitude', 'soi'),
        ),
        'model': {
            'map': _model(768, [12], [6]),
        },
        'inference': {
            'map': dict(num_particles=16, num_epochs=5000,
                        learning_rate=0.005, batch_size=221127),
            'vi': dict(num_particles=16, num_epochs=600, learning_rate=0.005,
                       batch_size=8845, kl_weight=0.5,
                       sample_size_divergence=5),
        },
    },
}

# The reference additionally ships a model-only M3Month stanza
# (dataset_config.py:170-178) with no dataset columns or inference config
# anywhere in its tree — it cannot be run through the CLI there either.
# Carried for config parity: `model_config('M3Month', ...)` works;
# `dataset_config`/`inference_config` raise KeyError like the reference's
# DATASET_CONFIG['M3Month'] / get_inference_config would.
_M3MONTH_MODEL = {
    'width': 1024,
    'depth': 2,
    'seasonality_periods': np.asarray([12]),
    'num_seasonal_harmonics': np.asarray([6]),
    # No observation_model key, exactly as upstream (the estimator default,
    # NORMAL, applies); no 'vi' stanza either.
}
REGISTRY['M3Month'] = {
    'model': {'map': _M3MONTH_MODEL, 'mle': _M3MONTH_MODEL},
    'inference': {},
}

# MLE shares MAP's model/inference configs; VI shares the MAP model unless
# overridden (mirrors the reference's `ret[ds]['mle'] = ret[ds]['map']`).
for _name, _cfg in REGISTRY.items():
  if _name == 'M3Month':
    continue
  _cfg['model'].setdefault('mle', _cfg['model']['map'])
  _cfg['model'].setdefault('vi', _cfg['model']['map'])
  _cfg['inference'].setdefault('mle', _cfg['inference']['map'])


def runnable_datasets():
  """Dataset names the CLIs can actually run (have a data stanza)."""
  return sorted(n for n, cfg in REGISTRY.items() if 'data' in cfg)


def dataset_config(name):
  return REGISTRY[name]['data']


def model_config(name, objective):
  return dict(REGISTRY[name]['model'][objective])


def inference_config(name, objective):
  return dict(REGISTRY[name]['inference'][objective])
