"""Import hygiene of the port: `bayesnf_torch` never pulls in JAX.

`bayesnf_tpu/__init__.py` imports JAX, so importing any `bayesnf_tpu` module
would too. The check runs in a fresh interpreter and compares
`sys.modules` before and after the import, since an interpreter may load
`jax` at start-up; the sources (and `chip_smoke.py` and `bench_torch.py`)
are also scanned.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'bayesnf_tpu', 'triton')
SOURCES = sorted((ROOT / 'bayesnf_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py', ROOT / 'bench_torch.py'
]

_PROBE = """
import json, pkgutil, sys
before = set(sys.modules)
import bayesnf_torch
for info in pkgutil.walk_packages(bayesnf_torch.__path__, 'bayesnf_torch.'):
  __import__(info.name)
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_importing_the_port_loads_no_jax():
  out = subprocess.run(
      [sys.executable, '-c', _PROBE], cwd=ROOT, check=True,
      capture_output=True, text=True, timeout=120,
  ).stdout
  added = json.loads(out.strip().splitlines()[-1])
  assert 'bayesnf_torch.spatiotemporal' in added
  assert 'bayesnf_torch.ops.fused_mlp' in added
  assert 'bayesnf_torch.cli.evaluate' in added
  assert 'bayesnf_torch.utils.profiling' in added
  assert [m for m in added if m.split('.')[0] in FORBIDDEN] == []


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_no_jax(path):
  imported = []
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      imported += [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and node.module:
      imported.append(node.module)
  assert [m for m in imported if m.split('.')[0] in FORBIDDEN] == []
