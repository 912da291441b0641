"""The port's CLI tools `selftest`, `parity_run` and `prepare_data`
(`bayesnf_torch/cli/`) on the CPU, held against the JAX package's.

- selftest: `_workload` gives the JAX tool's config, inputs and targets;
  the three agreement helpers give its check dicts on the same arrays,
  passing and failing; `main` refuses a device that is not a CUDA card with
  the default ('torch', 'kernel') pair, and with the pair set to ('torch',
  'torch') runs the whole flow at a tiny size with the JAX tool's 25
  checks in its order (its committed `SELFTEST_r05.json`).
- parity_run: at 2 particles x 20 epochs the artifact has the key tree of
  the JAX tool's `PARITY_r05.json`, and the golden's metrics are the JAX
  package's.
- the artifacts' `device_kind` (`utils/profiling.py`) is nvidia-smi's line
  for the device's card, found by PCI address, UUID or
  CUDA_VISIBLE_DEVICES, wherever nvidia-smi lists it.
- prepare_data: the cases of `tests/test_cli.py::TestPrepareData` on the
  port's copy, its pure functions equal to the JAX package's.
"""

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

from bayesnf_torch.cli import parity_run
from bayesnf_torch.cli import prepare_data
from bayesnf_torch.cli import registry
from bayesnf_torch.cli import selftest
from bayesnf_torch.utils import profiling
from bayesnf_tpu import metrics as jax_metrics
from bayesnf_tpu.cli import parity_run as jax_parity_run
from bayesnf_tpu.cli import prepare_data as jax_prepare_data
from bayesnf_tpu.cli import selftest as jax_selftest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ROOT = os.path.join(ROOT, 'tests', 'test_data')
TINY = ['--rows', '64', '--width', '16', '--epochs', '2', '--ensemble', '2']


def _key_tree(d):
  return {k: _key_tree(v) if isinstance(v, dict) else None
          for k, v in d.items()}


# --- selftest ----------------------------------------------------------------


def test_workload_matches_the_jax_tool():
  config, aug, y_normal, y_counts = selftest._workload(64, 16)
  j_config, j_aug, j_y_normal, j_y_counts = jax_selftest._workload(64, 16)
  assert ({f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
          == {f.name: getattr(j_config, f.name)
              for f in dataclasses.fields(j_config)})
  d = config.num_inputs
  assert aug.dtype == torch.float32 and aug.shape == j_aug.shape
  np.testing.assert_array_equal(aug[:, :d].numpy(), np.asarray(j_aug)[:, :d])
  np.testing.assert_array_equal(y_normal, np.asarray(j_y_normal))
  np.testing.assert_array_equal(y_counts, np.asarray(j_y_counts))
  np.testing.assert_allclose(aug.numpy(), np.asarray(j_aug), rtol=0,
                             atol=1e-5)


def _arrays(seed, offset):
  """Seeded (a, b) with b = a + offset * noise."""
  rng = np.random.default_rng(seed)
  a = rng.normal(size=(2, 50)) * 10.0
  return a, a + offset * rng.normal(size=a.shape)


def _counts(seed, flips):
  rng = np.random.default_rng(seed)
  a = rng.poisson(5.0, size=200).astype(np.float64)
  b = a.copy()
  b[:flips] += 1.0
  return a, b


# (helper name, arguments after the check name and before `checks`, ok).
HELPER_CASES = {
    'loss-pass': ('_loss_agreement', lambda: (*_arrays(0, 1e-4), 5e-3), True),
    'loss-fail': ('_loss_agreement', lambda: (*_arrays(0, 1.0), 5e-3), False),
    'pred-pass': ('_pred_agreement',
                  lambda: (*_arrays(1, 1e-4), 5e-3, 3.0), True),
    'pred-fail': ('_pred_agreement',
                  lambda: (*_arrays(1, 1.0), 5e-3, 3.0), False),
    'count-pass': ('_count_quantile_agreement', lambda: _counts(2, 2), True),
    'count-fail': ('_count_quantile_agreement', lambda: _counts(2, 3), False),
}


@pytest.mark.parametrize('case', HELPER_CASES)
def test_agreement_helpers_match_the_jax_tool(case):
  helper, args, ok = HELPER_CASES[case]
  got, want = [], []
  assert getattr(selftest, helper)('c', *args(), got) is ok
  assert getattr(jax_selftest, helper)('c', *args(), want) is ok
  assert len(got) == len(want) == 1
  assert list(got[0]) == list(want[0])
  for key, value in want[0].items():
    if isinstance(value, float):
      np.testing.assert_allclose(got[0][key], value, rtol=1e-12)
    else:
      assert got[0][key] == value, key


def test_main_refuses_a_cpu_device(capsys):
  assert selftest.BACKENDS == ('torch', 'kernel')
  assert selftest.main(['--device', 'cpu', *TINY]) != 0
  captured = capsys.readouterr()
  assert 'PASS' not in captured.out + captured.err
  assert 'CUDA' in captured.err


def test_main_runs_the_jax_tools_checks(tmp_path, monkeypatch, capsys):
  monkeypatch.setattr(selftest, 'BACKENDS', ('torch', 'torch'))
  out = tmp_path / 'selftest.json'
  assert selftest.main(['--device', 'cpu', *TINY, '--json-out',
                        str(out)]) == 0
  result = json.loads(out.read_text())
  with open(os.path.join(ROOT, 'SELFTEST_r05.json')) as f:
    jax_result = json.load(f)
  assert list(result) == list(jax_result)
  assert ([c['check'] for c in result['checks']]
          == [c['check'] for c in jax_result['checks']])
  assert result['num_checks'] == 25 and result['ok'] and not result['failed']
  assert result['backend'] == 'cpu' and result['device_kind'] == 'cpu'
  assert result['args'] == {'rows': 64, 'width': 16, 'epochs': 2,
                            'ensemble': 2, 'rtol': 5e-3}
  # Each check's detail keys are the JAX tool's.
  for got, want in zip(result['checks'], jax_result['checks']):
    assert list(got) == list(want), got['check']
  stdout = capsys.readouterr().out
  assert stdout.count('PASS ') == 25
  assert json.loads(stdout.strip().splitlines()[-1])['ok'] is True


# --- parity_run --------------------------------------------------------------


def test_parity_run_artifact(tmp_path):
  out = tmp_path / 'parity.json'
  assert parity_run.main([
      '--json-out', str(out), '--output_dir', str(tmp_path / 'run'),
      '--num_particles', '2', '--num_epochs', '20', '--device', 'cpu']) == 0
  artifact = json.loads(out.read_text())
  with open(os.path.join(ROOT, 'PARITY_r05.json')) as f:
    assert _key_tree(artifact) == _key_tree(json.load(f))
  assert artifact['config'] == {'num_particles': 2, 'num_epochs': 20,
                                'learning_rate': 0.005}
  assert artifact['backend'] == 'cpu' and artifact['device_kind'] == 'cpu'
  ours = artifact['train_region']['ours']
  assert all(np.isfinite(v) for v in ours.values())

  # The golden's train-region metrics, as the JAX tool computes them.
  train = pd.read_csv(os.path.join(DATA_ROOT, 'chickenpox.8.train.csv'),
                      index_col=0)
  y = train.sort_index()['chickenpox'].values.astype(np.float64)
  golden = pd.read_csv(
      os.path.join(DATA_ROOT, 'bnf-map.chickenpox.8.train-golden.pred.csv'),
      index_col=0).sort_index()
  scale = (golden['yhat_upper'].values - golden['yhat_lower'].values) / (
      2 * jax_parity_run._Z95)
  want = jax_parity_run._region_metrics(
      y, golden['yhat'].values, golden['yhat_lower'].values,
      golden['yhat_upper'].values,
      jax_metrics.crps_normal(y, golden['yhat'].values, scale))
  got = artifact['train_region']['reference_golden']
  assert list(got) == list(want)
  for key in want:
    np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


# --- device_kind --------------------------------------------------------------

# nvidia-smi lists every card of the host, in its own order: index, uuid,
# pci.bus_id, name, power.limit.
SMI_FULL = ('0, GPU-aaaa, 00000000:19:00.0, NVIDIA H100 80GB HBM3, 700.00 W\n'
            '1, GPU-bbbb, 00000000:3B:00.0, NVIDIA H100 80GB HBM3, 500.00 W\n'
            '2, GPU-cccc, 00000001:3B:00.0, NVIDIA H100 80GB HBM3, 600.00 W\n')
# A virtual machine may hide the addresses and the UUIDs.
SMI_HIDDEN = ('0, GPU-REDACTED, [N/A], NVIDIA H100 80GB HBM3, 700.00 W\n'
              '1, GPU-REDACTED, [N/A], NVIDIA H100 80GB HBM3, 500.00 W\n'
              '2, GPU-REDACTED, [N/A], NVIDIA H100 80GB HBM3, 600.00 W\n')


@pytest.mark.parametrize('smi, pci, uuid, visible, want', [
    # By PCI address: torch's index 0 is nvidia-smi's third card.
    (SMI_FULL, (1, 0x3B, 0), 'zzzz', None, '600.00 W'),
    (SMI_FULL, (0, 0x3B, 0), 'zzzz', None, '500.00 W'),
    # By UUID where the address does not match.
    (SMI_FULL, (0, 0x5D, 0), 'bbbb', None, '500.00 W'),
    # Neither shown: the card CUDA_VISIBLE_DEVICES puts at index 0.
    (SMI_HIDDEN, (0, 0x19, 0), 'aaaa', '2,0', '600.00 W'),
    (SMI_HIDDEN, (0, 0x19, 0), 'aaaa', None, '700.00 W'),
    (SMI_HIDDEN, (0, 0x19, 0), 'aaaa', 'GPU-aaaa', None),
    (SMI_FULL, (0, 0x5D, 0), 'zzzz', '7', None),
])
def test_device_kind_picks_the_devices_card(monkeypatch, smi, pci, uuid,
                                             visible, want):
  domain, bus, device = pci
  props = type('Props', (), dict(pci_domain_id=domain, pci_bus_id=bus,
                                 pci_device_id=device, uuid=uuid))
  monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda _: props)
  if visible is None:
    monkeypatch.delenv('CUDA_VISIBLE_DEVICES', raising=False)
  else:
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', visible)

  def run(argv, **kwargs):
    assert argv[1] == '--query-gpu=index,uuid,pci.bus_id,name,power.limit'
    return type('Done', (), dict(stdout=smi))
  monkeypatch.setattr(profiling.subprocess, 'run', run)
  if want is None:
    with pytest.raises(RuntimeError, match='no card'):
      profiling.device_kind('cuda:0')
  else:
    assert profiling.device_kind('cuda:0') == 'NVIDIA H100 80GB HBM3, ' + want
  assert profiling.device_kind('cpu') == 'cpu'


# --- prepare_data ------------------------------------------------------------


@pytest.mark.parametrize('dataset', registry.runnable_datasets())
def test_expected_files_match_the_jax_package(dataset):
  names = prepare_data.expected_files(dataset)
  assert names == jax_prepare_data.expected_files(dataset)
  assert len(names) == 2 * registry.dataset_config(dataset)['num_series']


def test_constants_match_the_jax_package():
  assert prepare_data.ZENODO_RECORD == jax_prepare_data.ZENODO_RECORD
  assert prepare_data.ZENODO_URL == jax_prepare_data.ZENODO_URL
  assert prepare_data.DOI == jax_prepare_data.DOI


def test_verify_reports_missing_then_ok(tmp_path):
  missing = prepare_data.verify_layout(str(tmp_path), ['chickenpox'])
  assert set(missing) == {'chickenpox'}
  assert missing == jax_prepare_data.verify_layout(str(tmp_path),
                                                   ['chickenpox'])
  for name in prepare_data.expected_files('chickenpox'):
    (tmp_path / name).write_text('stub')
  assert prepare_data.verify_layout(str(tmp_path), ['chickenpox']) == {}
  assert prepare_data.main(
      ['--verify-only', '--dest', str(tmp_path), '--datasets', 'chickenpox']
  ) == 0


def test_unpack_strips_single_root_dir(tmp_path):
  archive = tmp_path / 'datasets.zip'
  with zipfile.ZipFile(archive, 'w') as zf:
    zf.writestr('datasets/chickenpox.8.train.csv', 'a,b\n1,2\n')
    zf.writestr('datasets/chickenpox.8.test.csv', 'a,b\n3,4\n')
  dest = tmp_path / 'out'
  prepare_data.unpack(str(archive), str(dest))
  assert (dest / 'chickenpox.8.train.csv').read_text().startswith('a,b')
  # main() with --archive unpacks and verifies without network.
  assert prepare_data.main([
      '--archive', str(archive), '--dest', str(dest),
      '--datasets', 'chickenpox',
  ]) == 1  # only series 8 present: verification lists the rest


def test_unpack_recovers_deeply_nested_csvs(tmp_path):
  archive = tmp_path / 'datasets.zip'
  with zipfile.ZipFile(archive, 'w') as zf:
    zf.writestr('data/v2/chickenpox/chickenpox.8.train.csv', 'a,b\n1,2\n')
    zf.writestr('data/extra/readme.txt', 'notes')
  for package, dest in ((prepare_data, tmp_path / 'out'),
                        (jax_prepare_data, tmp_path / 'jax')):
    package.unpack(str(archive), str(dest))
    assert (dest / 'chickenpox.8.train.csv').read_text().startswith('a,b')
    # Non-dataset files keep their (root-stripped) relative placement.
    assert (dest / 'extra' / 'readme.txt').exists()
  assert (sorted(str(p.relative_to(tmp_path / 'out'))
                 for p in (tmp_path / 'out').rglob('*'))
          == sorted(str(p.relative_to(tmp_path / 'jax'))
                    for p in (tmp_path / 'jax').rglob('*')))


def test_list_mode_reports_found_vs_expected(tmp_path, capsys):
  (tmp_path / 'chickenpox.8.train.csv').write_text('stub')
  rc = prepare_data.main(
      ['--list', '--dest', str(tmp_path), '--datasets', 'chickenpox']
  )
  out = capsys.readouterr().out
  assert rc == 1
  assert 'chickenpox: 1/' in out
  assert 'missing:' in out


def test_deep_verify_catches_empty_and_wrong_header(tmp_path):
  cfg = registry.dataset_config('chickenpox')
  header = ','.join(cfg['feature_cols'] + [cfg['target_col']])
  for name in prepare_data.expected_files('chickenpox'):
    (tmp_path / name).write_text(header + '\n1,2,3,4\n')
  assert prepare_data.verify_layout(
      str(tmp_path), ['chickenpox'], deep=True
  ) == {}
  (tmp_path / 'chickenpox.0.train.csv').write_text('')
  (tmp_path / 'chickenpox.1.train.csv').write_text('x,y\n1,2\n')
  problems = prepare_data.verify_layout(
      str(tmp_path), ['chickenpox'], deep=True
  )
  assert problems == jax_prepare_data.verify_layout(
      str(tmp_path), ['chickenpox'], deep=True)
  assert any('empty' in p for p in problems['chickenpox'])
  assert any('header lacks' in p for p in problems['chickenpox'])


def test_deep_verify_matches_column_names_exactly(tmp_path):
  for name in prepare_data.expected_files('chickenpox'):
    (tmp_path / name).write_text(
        'notes: datetime colatitude longitude chickenpox\n1,2\n'
    )
  problems = prepare_data.verify_layout(
      str(tmp_path), ['chickenpox'], deep=True
  )['chickenpox']
  assert len(problems) == len(prepare_data.expected_files('chickenpox'))
  assert all('header lacks' in p for p in problems)
  # Quoted/spaced fields still count as exact matches.
  cfg = registry.dataset_config('chickenpox')
  header = ','.join(
      f'"{c}"' for c in cfg['feature_cols'] + [cfg['target_col']]
  )
  for name in prepare_data.expected_files('chickenpox'):
    (tmp_path / name).write_text(header + '\n1,2,3,4\n')
  assert prepare_data.verify_layout(
      str(tmp_path), ['chickenpox'], deep=True
  ) == {}


def test_unpack_rejects_conflicting_duplicate_basenames(tmp_path):
  archive = tmp_path / 'datasets.zip'
  with zipfile.ZipFile(archive, 'w') as zf:
    zf.writestr('data/chickenpox.8.train.csv', 'a,b\n1,2\n')
    zf.writestr('data/old/chickenpox.8.train.csv', 'a,b\n9,9\n')
  with pytest.raises(SystemExit, match='two different copies'):
    prepare_data.unpack(str(archive), str(tmp_path / 'out'))
  # Identical duplicates are harmless: keep the first, no error.
  archive2 = tmp_path / 'datasets2.zip'
  with zipfile.ZipFile(archive2, 'w') as zf:
    zf.writestr('data/chickenpox.8.train.csv', 'a,b\n1,2\n')
    zf.writestr('data/copy/chickenpox.8.train.csv', 'a,b\n1,2\n')
  dest = tmp_path / 'out2'
  prepare_data.unpack(str(archive2), str(dest))
  assert (dest / 'chickenpox.8.train.csv').read_text() == 'a,b\n1,2\n'


def test_file_md5_matches_hashlib(tmp_path):
  p = tmp_path / 'blob.bin'
  p.write_bytes(b'bayesnf' * 1000)
  want = hashlib.md5(b'bayesnf' * 1000).hexdigest()
  assert prepare_data.file_md5(str(p)) == want
  assert jax_prepare_data.file_md5(str(p)) == want


def test_unpack_rejects_zip_slip_entries(tmp_path):
  archive = tmp_path / 'evil.zip'
  with zipfile.ZipFile(archive, 'w') as zf:
    zf.writestr('ok.csv', 'a,b\n1,2\n')
    zf.writestr('../escape-lead.txt', 'x')
    zf.writestr('sub/../../escape-mid.txt', 'x')  # '..' mid-path
    zf.writestr('/abs.txt', 'x')
  dest = tmp_path / 'out'
  prepare_data.unpack(str(archive), str(dest))
  assert (dest / 'ok.csv').exists()
  assert not (tmp_path / 'escape-lead.txt').exists()
  assert not (tmp_path / 'escape-mid.txt').exists()
  written = {p.name for p in dest.rglob('*') if p.is_file()}
  assert written == {'ok.csv'}
