"""The port's experiment harness (`bayesnf_torch/cli/`, `utils/profiling.py`)
on the CPU.

- `run_experiment(device='cpu')` meets the assertions of
  `test_golden_mini_parity.py` (the reference's mini protocol on the bundled
  chickenpox-8 CSVs) for map, mle and vi, and writes the JAX CLI's three
  artifacts: the golden CSVs' columns and index, the `log.json` keys, one
  loss column per particle, and a metrics block that the written
  predictions reproduce.
- NaN targets with train/test CSVs that reuse index labels
  (`test_cli.py`'s case), `data_devices` over a repeated-'cpu' mesh, the
  flags of `main` (the streamed fit's among them), the streamed predict's
  flags (its `pred.csv` bit for bit the in-memory run's, its CRPS draws
  chunked) and arguments, the registry copy, and the profiling hooks.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from bayesnf_torch import metrics
from bayesnf_torch import spatiotemporal
from bayesnf_torch.cli import evaluate
from bayesnf_torch.cli import registry
from bayesnf_torch.utils import profiling
from bayesnf_tpu.cli import registry as jax_registry
import chip_smoke

torch.set_num_threads(1)

DATA_ROOT = os.path.join(os.path.dirname(__file__), 'test_data')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's mini protocol (test_golden_mini_parity.py:38-49) and its
# per-row assertions (:82-131), as the card's smoke run holds them.
MINI_INFERENCE = chip_smoke.MINI_INFERENCE
assert_mini_golden = chip_smoke.assert_mini_golden
LOG_KEYS = chip_smoke.LOG_KEYS
COLUMNS = ['yhat', 'yhat_p50', 'yhat_lower', 'yhat_upper']


def _read(name):
  return pd.read_csv(os.path.join(DATA_ROOT, name), index_col=0)


@pytest.fixture(scope='module')
def mini_runs(tmp_path_factory):
  """One mini-protocol run per objective: (stem, returned values)."""
  out = tmp_path_factory.mktemp('mini')
  runs = {}
  for objective in ('map', 'mle', 'vi'):
    returned = evaluate.run_experiment(
        dataset='chickenpox', data_root=DATA_ROOT, series_id='8',
        output_dir=str(out), objective=objective, seed=0,
        model_config=registry.model_config('chickenpox', objective),
        inference_config=dict(MINI_INFERENCE[objective]), device='cpu')
    runs[objective] = (str(out / f'bnf-{objective}.chickenpox.8'), returned)
  return runs


@pytest.mark.parametrize('objective', ['map', 'mle', 'vi'])
def test_mini_golden_per_row(mini_runs, objective):
  assert_mini_golden(mini_runs[objective][0] + '.pred.csv', objective)


@pytest.mark.parametrize('objective', ['map', 'mle', 'vi'])
def test_artifacts_match_the_reference_layout(mini_runs, objective):
  stem, (losses, means, quants) = mini_runs[objective]
  golden = _read(f'bnf-{objective}.chickenpox.8.mini.pred.csv')
  pred = pd.read_csv(stem + '.pred.csv', index_col=0)
  assert list(pred.columns) == COLUMNS == list(golden.columns)
  assert pred.index.equals(golden.index)
  assert (pred.yhat_lower <= pred.yhat_p50).all()
  assert (pred.yhat_p50 <= pred.yhat_upper).all()

  with open(stem + '.log.json') as f:
    log = json.load(f)
  assert list(log) == LOG_KEYS
  assert (log['dataset'], log['series_id'], log['objective']) == (
      'chickenpox', '8', objective)
  assert log['runtime'] > 0
  assert log['inference_config'] == MINI_INFERENCE[objective]
  for region in ('train', 'test'):
    assert sorted(log['metrics'][region]) == ['crps', 'mae', 'rmse']
    assert all(np.isfinite(v) for v in log['metrics'][region].values())

  loss = pd.read_csv(stem + '.loss.csv')
  particles = MINI_INFERENCE[objective]['num_particles']
  steps = MINI_INFERENCE[objective]['num_epochs']  # Full batch: 1 a epoch.
  assert loss.shape == (steps, particles)
  # Written as text: float32 to ~7 digits.
  np.testing.assert_allclose(loss.values.T, losses.reshape(particles, -1),
                             rtol=1e-6)

  # The metrics block: positional regions (train rows first), rmse and mae
  # of the ensemble-mean prediction, and the returned tensors on the CPU.
  assert means.device == torch.device('cpu')
  assert all(q.device == torch.device('cpu') for q in quants)
  y = pd.concat([_read('chickenpox.8.train.csv'),
                 _read('chickenpox.8.test.csv')])['chickenpox'].to_numpy()
  yhat = means.reshape(-1, len(y)).mean(dim=0).numpy()
  for region, rows in (('train', slice(0, 100)), ('test', slice(100, None))):
    for name in ('rmse', 'mae'):
      want = float(getattr(metrics, name)(y[rows], yhat[rows]))
      np.testing.assert_allclose(log['metrics'][region][name], want,
                                 rtol=1e-6)


def test_vi_crps_draws_flatten_every_leading_axis(mini_runs):
  """The VI predictive has (draws, groups, samples, members) leading axes:
  8 x 1 x 30 x 1 draws per row feed the CRPS."""
  _, (_, means, _) = mini_runs['vi']
  assert tuple(means.shape) == (1, 30, 1, 308)


def _small_model():
  cfg = registry.model_config('chickenpox', 'map')
  cfg.update(width=16)
  return cfg


def _small_inference(**kwargs):
  cfg = dict(MINI_INFERENCE['map'])
  cfg.update(kwargs)
  return cfg


def test_nan_targets_and_overlapping_index(tmp_path):
  """NaN targets in both splits and train/test CSVs that reuse index
  labels: metrics stay positional, predictions cover every row."""
  train = _read('chickenpox.8.train.csv').head(40).reset_index(drop=True)
  test = _read('chickenpox.8.test.csv').head(30).reset_index(drop=True)
  train.loc[[3, 17], 'chickenpox'] = np.nan
  test.loc[[0, 21], 'chickenpox'] = np.nan
  data_root = tmp_path / 'data'
  data_root.mkdir()
  train.to_csv(data_root / 'chickenpox.nan.train.csv')
  test.to_csv(data_root / 'chickenpox.nan.test.csv')

  _, means, _ = evaluate.run_experiment(
      dataset='chickenpox', data_root=str(data_root), series_id='nan',
      output_dir=str(tmp_path), objective='map', seed=0,
      model_config=_small_model(), inference_config=_small_inference(),
      device='cpu')
  stem = str(tmp_path / 'bnf-map.chickenpox.nan')
  with open(stem + '.log.json') as f:
    log = json.load(f)
  y = pd.concat([train, test])['chickenpox'].to_numpy()
  yhat = means.reshape(-1, 70).mean(dim=0).numpy()
  for region, rows in (('train', slice(0, 40)), ('test', slice(40, None))):
    valid = ~np.isnan(y[rows])
    assert valid.sum() == 38 if region == 'train' else 28
    np.testing.assert_allclose(
        log['metrics'][region]['rmse'],
        float(metrics.rmse(y[rows][valid], yhat[rows][valid])), rtol=1e-6)
    assert np.isfinite(log['metrics'][region]['crps'])
  pred = pd.read_csv(stem + '.pred.csv', index_col=0)
  assert len(pred) == 70 and np.all(np.isfinite(pred.values))


def test_data_devices_fit_over_a_repeated_cpu_mesh(tmp_path):
  """`data_devices=2` over ['cpu', 'cpu'] shards the 100 rows in two; the
  full-batch losses are the meshless run's up to the order of the sums."""
  runs = {}
  for name, device, extra in (('mesh', ['cpu', 'cpu'], {'data_devices': 2}),
                              ('one', 'cpu', {})):
    losses, _, _ = evaluate.run_experiment(
        dataset='chickenpox', data_root=DATA_ROOT, series_id='8',
        output_dir=str(tmp_path / name), objective='map', seed=0,
        model_config=_small_model(),
        inference_config=_small_inference(**extra), device=device)
    runs[name] = losses
  assert runs['mesh'].shape == (2, 2, 5)  # Group shape: the mesh's size.
  np.testing.assert_allclose(runs['mesh'].reshape(4, 5),
                             runs['one'].reshape(4, 5), rtol=1e-5)
  with pytest.raises(ValueError, match='must divide device count'):
    evaluate.run_experiment(
        dataset='chickenpox', data_root=DATA_ROOT, series_id='8',
        output_dir=str(tmp_path), objective='map', seed=0,
        model_config=_small_model(),
        inference_config=_small_inference(data_devices=2), device='cpu')


def test_main_passes_its_flags_to_the_fit(tmp_path, monkeypatch):
  calls = []
  fit = spatiotemporal.BayesianNeuralFieldMAP.fit

  def spy(self, table, seed, **kwargs):
    calls.append((self.width, seed, kwargs))
    self.width = 16  # Keep the CPU run small.
    return fit(self, table, seed, **kwargs)

  monkeypatch.setattr(spatiotemporal.BayesianNeuralFieldMAP, 'fit', spy)
  evaluate.main([
      '--dataset', 'chickenpox', '--objective', 'map', '--data_root',
      DATA_ROOT, '--output_dir', str(tmp_path), '--start_id', '8',
      '--stop_id', '9', '--device', 'cpu', '--backend', 'torch',
      '--precision', 'bf16', '--num_epochs', '2', '--batch_size', '50',
      '--num_particles', '3'])
  [(width, seed, kwargs)] = calls
  assert width == 256 and seed == 2023100408
  assert kwargs == dict(learning_rate=0.005, num_epochs=2, batch_size=50,
                        ensemble_size=3, backend='torch', precision='bf16',
                        device='cpu', num_splits=1)
  assert pd.read_csv(tmp_path / 'bnf-map.chickenpox.8.loss.csv').shape == (
      2, 3)


def test_main_streams_the_fit(tmp_path, monkeypatch):
  calls = []
  fit = spatiotemporal.BayesianNeuralFieldMAP.fit

  def spy(self, table, seed, **kwargs):
    calls.append(kwargs)
    self.width = 16  # Keep the CPU run small.
    return fit(self, table, seed, **kwargs)

  monkeypatch.setattr(spatiotemporal.BayesianNeuralFieldMAP, 'fit', spy)
  evaluate.main([
      '--dataset', 'chickenpox', '--objective', 'map', '--data_root',
      DATA_ROOT, '--output_dir', str(tmp_path), '--start_id', '8',
      '--stop_id', '9', '--device', 'cpu', '--backend', 'torch',
      '--num_epochs', '2', '--batch_size', '50', '--num_particles', '3',
      '--stream_chunk_steps', '3', '--stream_member_remix'])
  [kwargs] = calls
  assert kwargs['stream_chunk_steps'] == 3
  assert kwargs['stream_member_remix'] is True
  losses = pd.read_csv(tmp_path / 'bnf-map.chickenpox.8.loss.csv')
  assert losses.shape == (2, 3) and np.isfinite(losses.to_numpy()).all()
  with open(tmp_path / 'bnf-map.chickenpox.8.log.json') as f:
    assert json.load(f)['inference_config']['stream_chunk_steps'] == 3


def _main_args(output_dir, *flags):
  """`main`'s arguments for the chickenpox-8 MAP experiment on the CPU."""
  return ['--dataset', 'chickenpox', '--data_root', DATA_ROOT,
          '--output_dir', str(output_dir), '--start_id', '8', '--stop_id',
          '9', '--device', 'cpu', *flags]


# Two epochs of two particles: seconds on the CPU.
SMALL_RUN = ('--num_epochs', '2', '--num_particles', '2')


@pytest.fixture(scope='module')
def small_main_run(tmp_path_factory):
  """The output directory of a small in-memory run of `main`."""
  out = tmp_path_factory.mktemp('in-memory')
  evaluate.main(_main_args(out, *SMALL_RUN))
  return out


@pytest.mark.parametrize('flag', [
    ['--stream_chunk_steps', '4'], ['--stream_member_remix'],
    ['--stream_chunk_rows', '128'], ['--stream_cache_bytes', '0']])
def test_stream_flags_raise_not_implemented(tmp_path, flag, request):
  """The streamed fit's flags reach `fit`, which refuses what the JAX
  package refuses before any step: chickenpox's MAP stanza is full batch,
  and a remix needs streaming. The streamed predict's flags run:
  `--stream_chunk_rows` streams the predict and the CRPS draws (`pred.csv`
  bit for bit the in-memory run's, `log.json` says 'chunked'), and a cache
  budget alone leaves the in-memory run as it was."""
  fit_errors = {
      '--stream_chunk_steps': (ValueError, 'requires minibatch'),
      '--stream_member_remix': (ValueError, 'host-streaming'),
  }
  if flag[0] in fit_errors:
    error, match = fit_errors[flag[0]]
    with pytest.raises(error, match=match):
      evaluate.main(_main_args(tmp_path, *flag))
    assert not os.listdir(tmp_path)
    return
  in_memory = request.getfixturevalue('small_main_run')
  evaluate.main(_main_args(tmp_path, *SMALL_RUN, *flag))
  stem = 'bnf-map.chickenpox.8'
  with open(tmp_path / f'{stem}.pred.csv') as got, open(
      in_memory / f'{stem}.pred.csv') as want:
    assert got.read() == want.read()
  with open(tmp_path / f'{stem}.log.json') as got, open(
      in_memory / f'{stem}.log.json') as want:
    log, want_log = json.load(got), json.load(want)
  assert log['inference_config'][flag[0][2:]] == int(flag[1])
  assert want_log['crps_draws'] == 'single'
  if flag[0] == '--stream_chunk_rows':
    assert log['crps_draws'] == 'chunked'
    for region in ('train', 'test'):
      assert np.isfinite(log['metrics'][region]['crps'])
  else:
    assert log['crps_draws'] == 'single'
    assert log['metrics'] == want_log['metrics']


def test_predict_and_likelihood_model_take_the_stream_arguments():
  table = _read('chickenpox.8.train.csv').reset_index(drop=True)
  table['datetime'] = pd.to_datetime(table['datetime'])
  cfg = _small_model()
  cfg.update(feature_cols=['datetime', 'latitude', 'longitude'],
             target_col='chickenpox', timetype='index', freq='W',
             standardize=['latitude', 'longitude'])
  model = spatiotemporal.BayesianNeuralFieldMAP(**cfg).fit(
      table, 0, ensemble_size=2, num_epochs=1, device='cpu')
  means, quantiles = model.predict(table, stream_chunk_rows=None,
                                   stream_cache_bytes=None)
  dist = model.likelihood_model(table, stream_chunk_rows=None,
                                stream_cache_bytes=None)
  assert tuple(means.shape) == (1, 2, 100) == tuple(dist.mean().shape)
  # Streamed (a budget alone is ignored): the same values, bit for bit.
  for kwargs in ({'stream_chunk_rows': 1024}, {'stream_cache_bytes': 0},
                 {'stream_chunk_rows': 32, 'stream_cache_bytes': 1 << 20}):
    got_means, got_quantiles = model.predict(table, **kwargs)
    assert torch.equal(got_means, means)
    assert all(torch.equal(g, w) for g, w in zip(got_quantiles, quantiles))
    got = model.likelihood_model(table, **kwargs)
    assert torch.equal(got.mean(), dist.mean())
    assert torch.equal(got.stddev(), dist.stddev())


def test_registry_is_the_jax_registry():
  assert registry.REGISTRY.keys() == jax_registry.REGISTRY.keys()
  for name, cfg in registry.REGISTRY.items():
    want = jax_registry.REGISTRY[name]
    assert cfg.keys() == want.keys()
    if 'data' in cfg:
      assert cfg['data'] == want['data']
    assert cfg['inference'] == want['inference']
    assert cfg['model'].keys() == want['model'].keys()
    for objective, model in cfg['model'].items():
      assert model.keys() == want['model'][objective].keys()
      for key, value in model.items():
        np.testing.assert_array_equal(value, want['model'][objective][key])
  assert registry.runnable_datasets() == jax_registry.runnable_datasets()


def test_step_timer_and_maybe_trace_on_the_cpu(tmp_path, monkeypatch):
  with profiling.StepTimer(member_steps=40) as timer:
    torch.ones(64, 64).sum()
  assert timer.num_chips == 1 and timer.report.seconds > 0
  assert timer.report.member_steps_per_sec_per_chip == pytest.approx(
      40 / timer.report.seconds)
  assert 'member-steps/s/chip' in str(timer.report)
  assert profiling.StepTimer(1, num_chips=4).num_chips == 4

  with profiling.maybe_trace(None):
    pass
  trace_dir = tmp_path / 'traces'
  with profiling.maybe_trace(str(trace_dir)):
    torch.ones(8).sum()
  [trace] = os.listdir(trace_dir)
  with open(trace_dir / trace) as f:
    assert 'traceEvents' in json.load(f)

  # BNF_PROFILE_DIR traces run_experiment's fit and predict.
  monkeypatch.setenv('BNF_PROFILE_DIR', str(tmp_path / 'run'))
  evaluate.run_experiment(
      dataset='chickenpox', data_root=DATA_ROOT, series_id='8',
      output_dir=str(tmp_path), objective='map', seed=0,
      model_config=_small_model(),
      inference_config=_small_inference(num_epochs=1), device='cpu')
  assert len(os.listdir(tmp_path / 'run')) == 1


def test_module_runs_as_a_script():
  out = subprocess.run(
      [sys.executable, '-m', 'bayesnf_torch.cli.evaluate', '--help'],
      cwd=ROOT, check=True, capture_output=True, text=True, timeout=120)
  for flag in ('--backend', '--device', '--data_devices',
               '--stream_chunk_rows'):
    assert flag in out.stdout
