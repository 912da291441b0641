#!/usr/bin/env python3
"""How far apart two correct 'bf16' field MLPs can be: the noise floor of
the 'bf16' gates of `chip_smoke.py`.

    python3 bf16_noise_floor.py [--seeds 0 1 2]

Run from the root of a checkout on a machine with one CUDA card. For K2
(`fused_field_mlp_t`) and K3 (`fused_field_mlp_t_vjp`) at 'bf16', at
chip_smoke's shapes (64 members, F = 49), it prints one line a case with
the worst leaf's max |difference| over that leaf's largest magnitude
(the form of chip_smoke's 'bf16' gate, 2e-3) between:

- the kernel and the plain 'bf16' version (fp32 sums, as chip_smoke holds
  it);
- the kernel and the same rounding sites with the exact bf16 products
  summed in float64 (`exact`);
- the plain version and `exact`: what the fp32 summation order alone
  moves, which no fp32-sum implementation can be held below.

Leaves are numbered as `chip_smoke.flat_leaves` lists them (K3: dh0 per
feature group, then dW, db, dscales, dlogit). Imports nothing of JAX.
"""

import argparse
import contextlib
import sys

import numpy as np
import torch

import chip_smoke
from bayesnf_torch.ops import fused_mlp
from bayesnf_torch.ops import mixed

# (case, rows, width, depth), as phases 3 and 3b run them.
CASES = [('main', 4096, 512, 2), ('depth3', 1001, 512, 3),
         ('width1024', 4093, 1024, 2), ('width100', 4093, 100, 2)]


@contextlib.contextmanager
def float64_sums():
  """The plain 'bf16' version's rounded products summed in float64."""
  saved = mixed._exact_product  # pylint: disable=protected-access
  mixed._exact_product = lambda a16, b16: torch.matmul(  # pylint: disable=protected-access
      a16.double(), b16.double()).float()
  try:
    yield
  finally:
    mixed._exact_product = saved  # pylint: disable=protected-access


def worst(got, want):
  """'<max over leaves of max |got - want| / max |want|>@<leaf>'."""
  rel = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
         for g, w in zip(got, want)]
  i = int(np.argmax(rel))
  return f'{rel[i]:.3e}@{i}'


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seeds', type=int, nargs='+', default=[0])
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('bf16_noise_floor: needs a CUDA card.', file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  for seed in args.seeds:
    for case, n, width, depth in CASES:
      inputs = chip_smoke.kernel_inputs(chip_smoke.MEMBERS,
                                        chip_smoke.MAIN_GROUPS, n, width,
                                        depth, seed)
      g = torch.from_numpy(np.random.default_rng(seed + 1).normal(
          size=(chip_smoke.MEMBERS, n)).astype(np.float32)).cuda()
      calls = {
          'K2': (fused_mlp.fused_field_mlp_t,
                 fused_mlp.fused_field_mlp_t_reference, {}),
          'K3': (fused_mlp.fused_field_mlp_t_vjp,
                 fused_mlp.fused_field_mlp_t_vjp_reference, {'g': g}),
      }
      for kernel, (fn, plain, extra) in calls.items():
        def run(f):
          return chip_smoke.flat_leaves(f(depth, **inputs, **extra,  # pylint: disable=cell-var-from-loop
                                          precision='bf16'))
        got, want = run(fn), run(plain)
        with float64_sums():
          exact = run(plain)
        print(f'{kernel} case={case} seed={seed} rows={n} width={width} '
              f'depth={depth} kernel_vs_plain={worst(got, want)} '
              f'kernel_vs_exact={worst(got, exact)} '
              f'plain_vs_exact={worst(want, exact)}', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
