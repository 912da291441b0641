#!/usr/bin/env python3
"""Where a training step's time goes on one CUDA card ('kernel' backend).

    python3 profile_train.py [--seed N] [--steps N] [--precision P]

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc
(it builds K1 from the checkout's sources, as `chip_smoke.py` does). At the
workload of `chip_smoke.py` phases 6-7 (38,096 hourly rows, F = 49, width
512, depth 2), from parameters drawn by a one-epoch fit, it times and then
profiles steps of three fits:

- MAP full batch: 64 members, every row, one K1 call a step;
- MAP minibatch: 64 members, batch_size 3,500 (per-member inputs);
- VI: the published `air_quality` stanza, 16 surrogates x 5 draws over
  batch_size 3,500 (80 kernel members, grouped inputs).

at `--precision` ('f32', the default, or 'bf16': K1's tensor-core kernels).

One line each: host step time and member-steps/s (host clock around
synchronized steps, no profiler), then from torch.profiler over the same
number of further steps the device time of K1's kernels and of everything
else per step, the device busy share (device kernel time over the profiled
wall time), and the peak device memory. The card's name and power limit
come first.
"""

import argparse
import re
import subprocess
import sys
import time

import torch
import torch.profiler

import chip_smoke as cs
from bayesnf_torch.inference import map as map_lib
from bayesnf_torch.inference import vi as vi_lib
from bayesnf_torch.models import field as field_lib
from bayesnf_torch.models import likelihoods


def device_ms(prof, precision):
  """(K1's device ms, all device ms) of the profiled window."""
  k1 = total = 0.0
  for evt in prof.key_averages():
    us = getattr(evt, 'device_time_total', None)
    if us is None:
      us = evt.cuda_time_total
    if evt.device_type != torch.autograd.DeviceType.CUDA:
      continue
    total += us / 1e3
    found = re.search(r'(\w+_kernel)[<(]', evt.key)
    if found and found.group(1) in cs.K1_KERNELS[precision]:
      k1 += us / 1e3
  return k1, total


def measure(name, members, steps, run, precision):
  """Times `run()`, which takes `steps` steps, after a warm-up run, then
  profiles it; prints one line."""
  run()
  torch.cuda.synchronize()
  start = time.perf_counter()
  run()
  torch.cuda.synchronize()
  step_s = (time.perf_counter() - start) / steps
  torch.cuda.reset_peak_memory_stats()
  with torch.profiler.profile(activities=[
      torch.profiler.ProfilerActivity.CPU,
      torch.profiler.ProfilerActivity.CUDA]) as prof:
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
  k1_ms, total_ms = device_ms(prof, precision)
  print(f'{name}: precision={precision}, members={members}, steps={steps}, '
        f'host_step_s={step_s:.4f}, '
        f'member_steps_per_s={members / step_s:.2f}, '
        f'k1_ms_per_step={k1_ms / steps:.3f}, '
        f'other_device_ms_per_step={(total_ms - k1_ms) / steps:.3f}, '
        f'device_busy_share={total_ms / wall_ms:.4f}, '
        f'peak_memory_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}',
        flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--precision', choices=('f32', 'bf16'), default='f32')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('profile_train: CUDA is not available.', file=sys.stderr)
    return 1
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip(), flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  table = cs.bench_table(args.seed)
  normal = likelihoods.LikelihoodDist.NORMAL

  est, _ = cs.timed_fit(table, args.seed, 'kernel', num_epochs=1)
  train = est.data_handler.get_train(table)
  config = est._field_config(train.shape)  # pylint: disable=protected-access
  aug_t = field_lib.aug_features(
      config, torch.as_tensor(train, dtype=torch.float32, device='cuda')
  ).T.contiguous()
  y = torch.tensor(est.data_handler.get_target(table), dtype=torch.float32,
                   device='cuda')
  n = y.shape[0]
  params = tuple(p.reshape((-1,) + tuple(p.shape[2:])) for p in est.params_)
  state = map_lib.init_opt_state(params)

  def full():
    map_lib.train(params, state, aug_t, y, config, normal, 0.005, args.steps,
                  backend='kernel', precision=args.precision)

  generator = torch.Generator(device='cuda').manual_seed(args.seed)

  def permutations(_):
    return torch.argsort(torch.rand((cs.MEMBERS, n), generator=generator,
                                    device='cuda'), dim=-1)

  def minibatch():  # one epoch: n // BATCH steps
    map_lib.train(params, state, aug_t, y, config, normal, 0.005, 1,
                  backend='kernel', batch_size=cs.BATCH,
                  permutations=permutations, precision=args.precision)

  measure('map-full-batch', cs.MEMBERS, args.steps, full, args.precision)
  measure('map-minibatch', cs.MEMBERS, n // cs.BATCH, minibatch,
          args.precision)

  vi_est, _ = cs.vi_fit(table, args.seed, 'kernel')
  surrogate = vi_est.surrogate_
  vi_state = map_lib.init_opt_state((*surrogate[0], *surrogate[1]))

  def vi():
    vi_lib.train(surrogate, vi_state, aug_t, y, config, normal, cs.VI_LR,
                 args.steps, cs.BATCH, cs.VI_SAMPLES, cs.VI_KL_WEIGHT,
                 generator, 'kernel', args.precision)

  measure('vi', cs.VI_MEMBERS, args.steps, vi, args.precision)
  return 0


if __name__ == '__main__':
  sys.exit(main())
