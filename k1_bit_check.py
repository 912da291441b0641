#!/usr/bin/env python3
"""K1's outputs of one tree, hashed, to hold a change of shared kernel code
bit for bit to an earlier tree's on one card.

    python3 k1_bit_check.py --root DIR --out FILE.json   # hash DIR's K1
    python3 k1_bit_check.py --compare A.json B.json      # exit 1 if unequal

`--root` is the root of a checkout (default: this script's); its
`bayesnf_torch` is imported and its kernels are built from its sources.
Each case calls `fused_mlp.fused_train` on the card on inputs drawn from a
fixed numpy seed and writes the SHA-256 of every output tensor's bytes: two
trees whose K1 computes the same arithmetic give the same hashes. The cases
cover both precisions, the three likelihoods, shared and grouped inputs,
depths 0 and 3, width 100, a valid-row count and a call of several chunks.
Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

# (name, members, rows, width, depth, input groups, likelihood, precision,
# junk rows past n_valid, scratch budget in bytes)
CASES = [
    ('main', 64, 8192, 512, 2, None, 'NORMAL', 'f32', 0, None),
    ('main-bf16', 64, 8192, 512, 2, None, 'NORMAL', 'bf16', 0, None),
    ('grouped', 80, 3500, 512, 2, 16, 'NORMAL', 'f32', 0, None),
    ('grouped-bf16', 80, 3500, 512, 2, 16, 'NORMAL', 'bf16', 0, None),
    ('nb', 64, 2048, 256, 2, None, 'NB', 'f32', 0, None),
    ('zinb-bf16', 64, 2048, 256, 2, None, 'ZINB', 'bf16', 0, None),
    ('depth0-bf16', 64, 1000, 1, 0, None, 'NORMAL', 'bf16', 0, None),
    ('depth3', 64, 1001, 512, 3, None, 'NORMAL', 'f32', 0, None),
    ('width100-bf16', 64, 2000, 100, 2, None, 'NORMAL', 'bf16', 0, None),
    ('n_valid', 64, 8192, 512, 2, None, 'NORMAL', 'f32', 13, None),
    ('chunks-bf16', 64, 8192, 512, 2, None, 'NORMAL', 'bf16', 0, 300 << 20),
]
DEGREES = (5, 5, 5)
SEASONAL_ROWS = 16


def inputs(torch, members, n, width, depth, groups, likelihood, junk, seed=0):
  """K1's arguments on the card, scaled like an initialized model."""
  rng = np.random.default_rng(seed)
  d = len(DEGREES)
  f = d + 2 * sum(DEGREES) + SEASONAL_ROWS
  g = 1 + d + 1
  rows = n + junk
  lead = () if groups is None else (groups,)

  def cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).cuda()

  x = np.stack([np.tile(np.arange(rows, dtype=np.float64), lead + (1,)),
                rng.normal(size=lead + (rows,)),
                rng.normal(size=lead + (rows,))], axis=len(lead))
  seasonal = rng.uniform(-1, 1, lead + (SEASONAL_ROWS, rows))
  y = rng.normal(scale=5.0, size=lead + (rows,))
  if likelihood != 'NORMAL':
    y = rng.poisson(np.exp(y / 8.0) + 1.0).astype(np.float64)
    y.reshape(-1)[::7] = 0
  if junk:
    x[..., n:] = 9.9
    seasonal[..., n:] = -9.9
    y[..., n:] = np.nan
  fan_ins = [f] + [width] * depth
  fan_outs = [width] * depth + [1]
  return dict(
      distribution=likelihood, depth=depth, lik_scale=1.0,
      input_scales=(float(n), 1.0, 1.0), fourier_degrees=DEGREES,
      interactions=(), x_t=cuda(x), seasonal_t=cuda(seasonal),
      weights=[cuda(np.clip(rng.normal(size=(members, fi, fo)), -2, 2))
               for fi, fo in zip(fan_ins, fan_outs)],
      biases=[cuda(rng.normal(scale=0.1, size=(members, fo)))
              for fo in fan_outs],
      lsa=cuda(rng.normal(scale=0.1, size=(members, d))),
      fs_raw=cuda(rng.normal(scale=0.1, size=(members, g))),
      scales_raw=cuda(rng.normal(scale=0.1, size=(members, depth + 1))),
      logit=cuda(rng.normal(scale=0.5, size=(members,))),
      obs_raw=cuda(np.stack([1.0 + rng.normal(scale=0.1, size=members),
                             rng.normal(size=members),
                             rng.normal(size=members)], axis=-1)),
      y=cuda(y),
  )


def hashes(root):
  """{case: [SHA-256 of each output tensor]} of `root`'s K1."""
  sys.path.insert(0, os.path.abspath(root))
  import torch  # pylint: disable=g-import-not-at-top
  from bayesnf_torch.ops import fused_mlp  # pylint: disable=g-import-not-at-top
  assert fused_mlp.__file__.startswith(os.path.abspath(root)), fused_mlp.__file__
  if not torch.cuda.is_available():
    raise SystemExit('k1_bit_check: needs a CUDA card.')
  default_budget = fused_mlp.TRAIN_SCRATCH_BYTES
  result = {}
  for (name, members, n, width, depth, groups, likelihood, precision, junk,
       budget) in CASES:
    args = inputs(torch, members, n, width, depth, groups, likelihood, junk)
    fused_mlp.TRAIN_SCRATCH_BYTES = budget or default_budget
    outs = fused_mlp.fused_train(**args, precision=precision,
                                 n_valid=n if junk else None)
    torch.cuda.synchronize()
    flat = []
    for o in outs:
      flat += list(o) if isinstance(o, (tuple, list)) else [o]
    result[name] = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                    for t in flat]
    assert all(bool(torch.isfinite(t).all()) for t in flat), name
  fused_mlp.TRAIN_SCRATCH_BYTES = default_budget
  return result


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--root', default=os.path.dirname(
      os.path.abspath(__file__)))
  parser.add_argument('--out')
  parser.add_argument('--compare', nargs=2)
  args = parser.parse_args(argv)
  if args.compare:
    a, b = (json.load(open(p)) for p in args.compare)
    differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    print(json.dumps({'k1_bit_equal': not differ, 'cases': len(a),
                      'differ': differ}))
    return 1 if differ else 0
  result = hashes(args.root)
  with open(args.out, 'w') as f:
    json.dump(result, f, indent=1)
  print(f'k1_bit_check: {len(result)} cases of {args.root} -> {args.out}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
