"""Finds what `BENCHMARK.json` names: each configuration's file, each
traffic mix (`traffic/<name>.json`), each cell's limits
(`limits/<workload>.json`), each per-layer metric's reader
(`metrics/<name>.py`), each table generator (`tables/<name>.py`) and each
configuration's plain reference (`reference/<name>.py`). Adding a cell, a
configuration or a metric adds files and entries and edits none.
"""

import hashlib
import importlib.util
import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent


def load_module(path):
  """The Python file `path` as a module of its own."""
  path = pathlib.Path(path)
  name = 'benchmark_file_' + hashlib.sha1(str(path).encode()).hexdigest()[:12]
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def derive(seed, tag):
  """A 63-bit seed of its own for stream `tag` of the run's `seed`."""
  state = np.random.SeedSequence([int(seed) % (1 << 64), int(tag)])
  return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Bench:
  """`BENCHMARK.json` and the files it names, under `root` (the benchmark's
  folder) and `repo` (where the configurations' paths start)."""

  def __init__(self, spec=None, root=ROOT, repo=REPO):
    self.root, self.repo = pathlib.Path(root), pathlib.Path(repo)
    if spec is None:
      spec = json.loads((self.repo / 'BENCHMARK.json').read_text())
    self.spec = spec

  def workload(self, name):
    for w in self.spec['workloads']:
      if w['name'] == name:
        return w
    raise KeyError(f'No workload {name!r} in BENCHMARK.json.')

  def config(self, name):
    for c in self.spec['configs']:
      if c['name'] == name:
        return json.loads((self.repo / c['file']).read_text())
    raise KeyError(f'No configuration {name!r} in BENCHMARK.json.')

  def traffic(self, name):
    return json.loads((self.root / 'traffic' / f'{name}.json').read_text())

  def limits(self, workload):
    path = self.root / 'limits' / f'{workload}.json'
    return json.loads(path.read_text()) if path.exists() else None

  def reader(self, metric):
    return load_module(self.root / 'metrics' / f'{metric}.py')

  def table(self, generator):
    return load_module(self.root / 'tables' / f'{generator}.py')

  def reference(self, name):
    return load_module(self.root / 'reference' / f'{name}.py')

  def _applies(self, metric, workload):
    return workload in metric.get('workloads', (workload,))

  def end_to_end(self, workload):
    return [m for m in self.spec['end_to_end'] if self._applies(m, workload)]

  def per_layer(self, workload):
    """The per-layer metrics read in `workload`: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    reported = {m['name'] for m in self.end_to_end(workload)}
    return [m for m in self.spec['per_layer']
            if (workload in m['workloads'] if 'workloads' in m
                else m['moves'] in reported)]
