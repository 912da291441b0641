"""Peak device memory of `chip_smoke.py` phase 15 (c)'s streamed epochs.

Phase 15 (c) holds the peak of one streamed 'bf16' MAP epoch over a
2,000,000-row memmap to within 16 MiB of the 38,096-row table's. This probe
runs each of those two epochs REPEATS times (the same helpers, model and
seed) with the prior's gradient taken in closed form (the trainer's
`map._prior_losses_and_grads`) and then by autograd (how the trainer took
it before), with `--busy` host processes competing for the CPU. It records
the allocator's history over each size's last epoch and lists the
allocations live at the peak by their Python stack.

Run on a CUDA card, from the repo root:

  python3 stream_memory_probe.py --busy 16
"""

import argparse
import collections
import concurrent.futures
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.models import priors
from bayesnf_torch.ops import _build

REPEATS = 3
SEED = 0


def autograd_prior(config, params, prior_weight):
  """-prior_weight * prior_log_prob per member and its gradient, by
  autograd."""
  leaves = [p.detach().requires_grad_(True) for p in params]
  with torch.enable_grad():
    losses = -prior_weight * priors.prior_log_prob(config, leaves)
    grads = torch.autograd.grad(losses.sum(), leaves)
  return losses.detach(), list(grads)


def live_at_peak(snapshot, top=12):
  """Lines of the allocations live at the peak of a recorded history,
  grouped by size and the repository frames that made them."""
  live, current, best, at_best = {}, 0, 0, {}
  for event in snapshot['device_traces'][0]:
    if event['action'] == 'alloc':
      live[event['addr']] = event
      current += event['size']
      if current > best:
        best, at_best = current, dict(live)
    elif event['action'] == 'free_completed':
      current -= live.pop(event['addr'], event)['size']
  groups = collections.defaultdict(lambda: [0, 0])
  for event in at_best.values():
    frames = [f for f in event.get('frames', [])
              if 'bayesnf_torch' in f['filename']][:3]
    where = ' <- '.join(f'{os.path.basename(f["filename"])}:{f["line"]}'
                        for f in frames) or '(no Python frame)'
    groups[event['size'], where][0] += 1
    groups[event['size'], where][1] += event['size']
  lines = [f'  replayed peak {best} bytes above the start']
  for (size, where), (count, total) in sorted(
      groups.items(), key=lambda item: -item[1][1])[:top]:
    lines.append(f'  {total:>12} = {count} x {size}: {where}')
  return lines


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--busy', type=int, default=0,
                      help='busy host processes during the epochs')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('stream_memory_probe: CUDA is not available.', file=sys.stderr)
    return 1
  print(chip_smoke.profiling.device_kind('cuda'), flush=True)
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    list(pool.map(_build.build, ('fused_mlp_t', 'fused_train')))
  table = chip_smoke.bench_table(SEED)
  est = chip_smoke.bench_estimator()
  train = est.data_handler.get_train(table)
  config = est._field_config(train.shape)  # pylint: disable=protected-access
  target = est.data_handler.get_target(table)
  small = (chip_smoke.field_lib.aug_features_host(config, train), target)
  closed = map_lib._prior_losses_and_grads  # pylint: disable=protected-access
  priors_run = (('closed', closed), ('autograd', autograd_prior))
  busy = []
  peaks = collections.defaultdict(list)
  try:
    with tempfile.TemporaryDirectory() as tmp:
      big = chip_smoke.memmap_rows(config, chip_smoke.MEMMAP_ROWS, SEED, tmp)
      busy = [subprocess.Popen([sys.executable, '-c', 'while True: pass'])
              for _ in range(args.busy)]
      for prior_name, prior_fn in priors_run:
        map_lib._prior_losses_and_grads = prior_fn  # pylint: disable=protected-access
        for size, (aug, y) in (('38096', small), ('2000000', big)):
          for repeat in range(REPEATS):
            history = repeat == REPEATS - 1
            if history:
              torch.cuda.memory._record_memory_history(  # pylint: disable=protected-access
                  max_entries=2_000_000, stacks='python')
            peak, seconds = chip_smoke.streamed_epoch_peak(aug, y, config, SEED)
            peaks[prior_name, size].append(peak)
            print(f'prior={prior_name} rows={size} busy={args.busy} '
                  f'peak_bytes={peak} peak_mib={peak / 2**20:.2f} '
                  f'epoch_s={seconds:.2f}', flush=True)
            if history:
              snapshot = torch.cuda.memory._snapshot()  # pylint: disable=protected-access
              torch.cuda.memory._record_memory_history(enabled=None)  # pylint: disable=protected-access
              print('\n'.join(live_at_peak(snapshot)), flush=True)
      del big
  finally:
    map_lib._prior_losses_and_grads = closed  # pylint: disable=protected-access
    for process in busy:
      process.kill()
    for process in busy:
      process.wait()
  for prior_name, _ in priors_run:
    gaps = [b - s for s in peaks[prior_name, '38096']
            for b in peaks[prior_name, '2000000']]
    print(f'prior={prior_name} largest gap {max(gaps)} bytes '
          f'({max(gaps) / 2**20:.2f} MiB; phase 15 (c) allows '
          f'{chip_smoke.MEMORY_GAP_BYTES / 2**20:.0f} MiB)', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
