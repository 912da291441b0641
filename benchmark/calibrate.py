"""The readings that a cell's limits are set from.

    python -m benchmark.calibrate --workload <name> --seeds 1,2,... \
        [--controls 3] [--out readings.jsonl]

For every seed, one line with the numbers of a sound run of the program
(`kind: program`): its training check steps, or one predict call of every
grid. For the first `--controls` seeds also the numbers of the control and
of the planted faults, each put in the program's place:

- `control`: the plain reference one precision down: its products in TF32,
  and the mixture quantiles' CDF in bfloat16;
- training: `half_batch` (the likelihood over half of each batch, times
  two) and `unchanged` (a step that returns its state unchanged);
- prediction: `half_members` (the quantiles of half of the members) and
  `altered` (the answers of row 1 returned for row 0 too).

No measured window runs. Needs the cell's card, as a run does.
"""

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import loads
from benchmark import spec


def _unchanged(load):
  losses, grad, _ = load.reference_readings()
  return (losses[:, :1].repeat(1, losses.shape[1]),
          [torch.zeros_like(g) for g in grad], load.start)


def _altered(outputs):
  out = {}
  for g, (means, q) in outputs.items():
    means, q = means.clone(), q.clone()
    means[..., 0] = means[..., 1]
    q[:, 0] = q[:, 1]
    out[g] = (means, q)
  return out


def readings(load, controls):
  """[(kind, numbers)] of one seed's load, after its set-up."""
  if isinstance(load, loads.Fit):
    found = [('program', load.numbers(load.program))]
    if controls:
      found += [
          ('control', load.numbers(load.reference_readings('tf32'))),
          ('half_batch', load.numbers(
              load.reference_readings('f32', half_batch=True))),
          ('unchanged', load.numbers(_unchanged(load)))]
    return found
  grids = range(len(load.grids))
  for g in grids:
    load.call(g)
  load.release()
  found = [('program', load.numbers(load.kept))]
  if controls:
    half = load.start[0].shape[0] // 2
    found += [
        ('control', load.numbers(
            {g: load.reference_outputs(g, 'tf32') for g in grids})),
        ('half_members', load.numbers(
            {g: load.reference_outputs(g, members=half) for g in grids})),
        ('altered', load.numbers(_altered(
            {g: load.reference_outputs(g) for g in grids})))]
  return found


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', required=True)
  parser.add_argument('--controls', type=int, default=3)
  parser.add_argument('--out', default=None)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('calibrate: no CUDA card.', file=sys.stderr)
    return 2
  bench = spec.Bench()
  cell = bench.workload(args.workload)
  cfg = bench.config(cell['config'])
  traffic = bench.traffic(cell['traffic'])
  with (open(args.out, 'a') if args.out
        else contextlib.nullcontext()) as out:
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
      tic = time.perf_counter()
      load = loads.make(cfg, traffic, seed, 'cuda', cfg['backend'],
                        bench.table(cfg['table']['generator']),
                        bench.reference(cfg['reference']))
      load.setup()
      setup_s = time.perf_counter() - tic
      for kind, numbers in readings(load, i < args.controls):
        line = json.dumps(dict(workload=args.workload, seed=seed, kind=kind,
                               setup_s=setup_s, **numbers))
        print(line, flush=True)
        if out:
          out.write(line + '\n')
          out.flush()
      del load
      torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main())
