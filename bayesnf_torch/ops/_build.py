"""Builds the port's CUDA kernels from `csrc/` with nvcc, and loads them.

Each kernel source is compiled at first use into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named by a
hash of the sources and the flags, in `build/` beside this file. The
library is loaded with `ctypes`; the wrappers declare the argument types.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC_DIR = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
    '-Xptxas', '-v',
)


def _nvcc() -> str:
  for root in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
    if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
      return os.path.join(root, 'bin', 'nvcc')
  found = shutil.which('nvcc') or (
      '/usr/local/cuda/bin/nvcc'
      if os.path.isfile('/usr/local/cuda/bin/nvcc') else None
  )
  if found is None:
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME or put nvcc on PATH); the port\'s '
        'CUDA kernels are built from source at first use.'
    )
  return found


def library_path(name: str) -> pathlib.Path:
  """Where the library for `csrc/<name>.cu` lives for these sources/flags."""
  digest = hashlib.sha256()
  for src in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  digest.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(name: str) -> tuple[pathlib.Path, float, str]:
  """Compiles `csrc/<name>.cu` unless its library exists.

  Returns (library path, build seconds (0.0 if it existed), the compiler's
  report, which `-Xptxas -v` fills with registers, spills and shared memory
  per kernel).

  Raises:
    RuntimeError: if nvcc is missing or the compile fails.
  """
  path = library_path(name)
  if path.exists():
    return path, 0.0, ''
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  # Compile to a private name, then rename: concurrent processes never see a
  # half-written library.
  fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
  os.close(fd)
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC_DIR / f'{name}.cu')]
  start = time.perf_counter()
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(
          f'nvcc failed ({proc.returncode}) building {name}:\n'
          f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}'
      )
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return path, time.perf_counter() - start, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
  """The loaded library for `csrc/<name>.cu`, built first if needed."""
  path, _, _ = build(name)
  return ctypes.CDLL(str(path))
