"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference computes from the same inputs, and
their judgement against a cell's limits.

Training (`fit_numbers`), over the first steps of the window's own call:

- `loss_gap`: the largest |program - reference| / |reference| of a
  member's loss over the steps compared;
- `grad_gap`: over every leaf of every member, |‖g_prog‖ - ‖g_ref‖| of the
  first step's gradient (the program's read from its Adam state after one
  step, mu / (1 - b1)), over the larger of ‖g_ref‖ and the median leaf's
  ‖g_ref‖; the largest;
- `change_gap`: the same of the parameters' change over the steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with a gradient that is nought to rounding moves under Adam
  by rounding alone);
- `grad_median_gap`, `change_median_gap`: the median leaf's gap of the
  gradient and of the change, steady from seed to seed where the largest
  swings: a leaf of a few entries whose gradient is a sum over every row
  with much cancellation (the log scale adjustments), or whose gradient
  crosses zero in the later steps, reads 3-10 times the other seeds'
  largest on a few seeds.

Prediction (`predict_numbers`), over every grid a run kept:

- `mean_gap`: the largest |program - reference| of a member's predictive
  mean, over the root mean square of the reference's means;
- `quantile_residual`: the largest |F(x) - q| of a quantile x the program
  returned for q, F the reference's mixture CDF (float64, over the
  reference's means), the residual to which the estimator states it
  root-finds its quantiles.

A cell's limits file names the numbers it compares; a number that is not
finite fails its limit.
"""

import math

import torch

GRAD_FLOOR = 1e-3  # Of the median leaf's gradient norm: leaves below move
# by rounding alone and are left out of `change_gap`.


def _norms(leaves):
  """(member, leaf) norms of leaves with a leading member axis."""
  return torch.stack([t.reshape(t.shape[0], -1).double().norm(dim=1)
                      for t in leaves], dim=1)


def _norm_gaps(prog, ref, keep=None):
  """|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) of every (member, leaf),
  or of those `keep` marks."""
  a, b = _norms(prog), _norms(ref)
  if keep is not None:
    a, b = a[keep], b[keep]
  return (a - b).abs() / torch.clamp(b, min=float(b.median()))


def fit_numbers(prog, ref, start):
  """The training numbers from (losses (E, T), first gradient leaves,
  parameter leaves after the T steps) of the program and of the reference,
  and the parameters both started from."""
  (p_loss, p_grad, p_end), (r_loss, r_grad, r_end) = prog, ref
  r_loss64 = r_loss.double()
  loss_gap = float(((p_loss.double() - r_loss64).abs()
                    / r_loss64.abs()).max())
  g = _norms(r_grad)
  keep = g >= GRAD_FLOOR * float(g.median())
  change = [[e.double() - s.double() for e, s in zip(end, start)]
            for end in (p_end, r_end)]
  grads = _norm_gaps(p_grad, r_grad)
  changes = _norm_gaps(change[0], change[1], keep)
  return {
      'loss_gap': loss_gap,
      'grad_gap': float(grads.max()),
      'grad_median_gap': float(grads.median()),
      'change_gap': float(changes.max()),
      'change_median_gap': float(changes.median()),
  }


def predict_numbers(p_means, p_quantiles, r_means, cdf, quantiles):
  """The prediction numbers of one grid: the program's means (K, n) and
  quantiles (Q, n) against the reference's means (K, n) and mixture CDF
  `cdf(x (n,)) -> (n,)`."""
  r_means = r_means.double()
  rms = float(torch.sqrt((r_means ** 2).mean()))
  residual = max(float((cdf(x) - q).abs().max())
                 for x, q in zip(p_quantiles, quantiles))
  return {
      'mean_gap': float((p_means.double() - r_means).abs().max()) / rms,
      'quantile_residual': residual,
  }


def worst(readings):
  """Each number's largest value over several readings (NaN if any is)."""
  out = {}
  for r in readings:
    for k, v in r.items():
      old = out.get(k)
      if old is None or math.isnan(v) or (not math.isnan(old) and v > old):
        out[k] = v
  return out


def judge(numbers, limits):
  """(correct, {name: {'value', 'limit'}}) over the numbers that `limits`
  names: every one of them at or under its limit. A cell without limits is
  not correct."""
  table = {k: {'value': numbers.get(k, math.nan), 'limit': v}
           for k, v in (limits or {}).items()}
  ok = bool(table) and all(row['value'] <= row['limit']
                           for row in table.values())
  return ok, table
