"""Nothing the benchmark's command or reference loads is JAX or the JAX
package (top-level names compared whole: `bayesnf_torch` begins with
`bayesnf_t`), and the reference loads nothing of the program."""

import json
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'bayesnf_tpu'}

_LOADED = """
import json, sys
from benchmark import spec
bench = spec.Bench()
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body):
  out = subprocess.run(
      [sys.executable, '-c', _LOADED.format(body=body)], cwd=spec.REPO,
      check=True, capture_output=True, text=True, timeout=300).stdout
  return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
  loaded = _top_level(
      'from benchmark import run, harness, loads, calibrate\n'
      'import bayesnf_torch.inference.map, bayesnf_torch.inference.vi\n'
      'import bayesnf_torch.inference.predict\n'
      '[bench.reader(m["name"]) for m in bench.spec["per_layer"]]\n'
      '[bench.table(g) for g in ("hourly", "sst")]')
  assert 'bayesnf_torch' in loaded
  assert not loaded & FORBIDDEN


def test_reference_loads_neither_jax_nor_the_program():
  loaded = _top_level('bench.reference("bayesnf_field")')
  assert not loaded & (FORBIDDEN | {'bayesnf_torch'})


def test_forbidden_names_are_compared_whole(monkeypatch):
  from benchmark import harness
  fake = type(sys)('fake')
  monkeypatch.setitem(sys.modules, 'bayesnf_tpux', fake)
  assert harness.forbidden_modules() == []
  monkeypatch.setitem(sys.modules, 'jax.numpy', fake)
  assert harness.forbidden_modules() == ['jax']
