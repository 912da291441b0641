"""The benchmark of `bayesnf_torch` on one CUDA card: one run of one cell.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds `bayesnf_torch`. The cell (a
configuration under a traffic mix, `BENCHMARK.json`) is set up from the
seed, then measured for `--seconds` (`--trace 0`: the cell's end-to-end
metrics; `--trace 1`: the window, then two profiled stretches of fixed
length, for its per-layer metrics), then checked against the plain
reference and its kernel launches counted against what the work asks
for. The last line of
standard output is the result, a JSON object; the line before it holds
what the run counted (steps or calls, call latencies). Each number the
check compared is printed beside its limit as the last lines of standard
error and under the result's last key, `checks`.

Exits 2 without a CUDA card (or with fewer than the cell asks for) and 3
if a module of JAX or of the JAX package was loaded; neither prints a
result. The program's kernel caches stay in the checkout (`.benchrun/`).
"""

import time

STARTED = time.monotonic()

# pylint: disable=g-import-not-at-top,wrong-import-position
import argparse
import json
import os
import sys

from benchmark import spec


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)

  out_dir = os.path.join(spec.REPO, '.benchrun')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(out_dir, 'torch_ext')
  os.environ['TRITON_CACHE_DIR'] = os.path.join(out_dir, 'triton')
  import torch
  from benchmark import harness
  bench = spec.Bench()
  chips = bench.workload(args.workload)['chips']
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f'benchmark: the cell needs {chips} CUDA card(s); '
          f'{torch.cuda.device_count()} available.', file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  result, info = harness.run(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), STARTED, out_dir=out_dir)
  found = harness.forbidden_modules()
  if found:
    print(f'benchmark: modules {found} were loaded.', file=sys.stderr)
    return 3
  print(json.dumps({'info': info}), flush=True)
  for name, row in result['checks'].items():
    print(f'check {name}: {row["value"]!r} limit {row["limit"]!r}',
          file=sys.stderr, flush=True)
  print(json.dumps(result), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
