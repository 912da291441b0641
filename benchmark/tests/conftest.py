"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
folder with tiny cells added by files and entries only, driven on the CPU
through the program's 'torch' backend."""

import copy
import json
import shutil

import pytest

from benchmark import spec

TINY = {'rows': 256, 'width': 8, 'members': 2, 'vi_batch': 64, 'draws': 2,
        'posterior': 3}
# Each tiny cell, and the cell whose traffic and limits it takes.
TINY_CELLS = {'tiny.map_fit': 'air_quality.map_fit',
              'tiny.vi_fit': 'air_quality.vi_fit',
              'tiny.vi_predict': 'air_quality.vi_predict'}


def tiny_config():
  cfg = json.loads((spec.ROOT / 'configs' / 'air_quality.json').read_text())
  cfg = copy.deepcopy(cfg)
  cfg['name'] = 'tiny'
  cfg['table']['rows'] = TINY['rows']
  cfg['model']['width'] = TINY['width']
  cfg['inference']['map'].update(num_particles=TINY['members'],
                                 batch_size=TINY['rows'])
  cfg['inference']['vi'].update(num_particles=TINY['members'],
                                batch_size=TINY['vi_batch'],
                                sample_size_divergence=TINY['draws'])
  cfg['posterior_draws'] = TINY['posterior']
  return cfg


@pytest.fixture
def tiny_bench(tmp_path):
  """A `spec.Bench` over a copy of the benchmark's folder in which the tiny
  cells were added as files (a configuration, a limits file each) and
  entries of BENCHMARK.json, and nothing else changed."""
  root = tmp_path / 'benchmark'
  shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns(
      'tests', '__pycache__'))
  (root / 'configs' / 'tiny.json').write_text(json.dumps(tiny_config()))
  bench = json.loads((spec.REPO / 'BENCHMARK.json').read_text())
  bench['configs'].append({'name': 'tiny', 'source': 'a test',
                           'file': 'benchmark/configs/tiny.json',
                           'reduced': ['rows'], 'why': 'a test'})
  for name, like in TINY_CELLS.items():
    cell = dict(bench_workload(bench, like), name=name, config='tiny')
    bench['workloads'].append(cell)
    shutil.copy(root / 'limits' / f'{like}.json',
                root / 'limits' / f'{name}.json')
    for metric in bench['end_to_end'] + bench['per_layer']:
      if like in metric.get('workloads', ()):
        metric['workloads'].append(name)
  return spec.Bench(bench, root=root, repo=tmp_path)


def bench_workload(bench, name):
  return next(w for w in bench['workloads'] if w['name'] == name)
