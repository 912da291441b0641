"""The yardstick's peaks and the operation and byte counts of the port's
kernels, frozen here so that no later change to the program moves them.

Copied from `chip_smoke.py` (`PEAK_*`, `bound_ms`, `mlp_flops_per_row`,
`field_mlp_bound`, `k1_bound`). The bounds take a dict of argument tensors
as the kernels do; only `.shape` and `.numel()` are read, so tensors on the
'meta' device (`meta_args`) serve and hold no memory.
"""

import torch

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): fp32 outside
# the tensor cores, dense bf16 on the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flops, nbytes, bf16_flops=0):
  """(least ms the card could take, 'operations' or 'bytes'): the larger of
  the products (fp32 ones at the SIMT peak, bf16 ones at the tensor cores')
  and the bytes at the HBM rate."""
  ops_ms = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
  bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
  return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def mlp_flops_per_row(f, width, depth):
  """Multiply-adds x 2 of one row and member through the field MLP."""
  return 2 * (f * width + (depth - 1) * width * width + width) if depth else (
      2 * f)


def field_mlp_bound(args, depth, precision='f32', layout='features',
                    backward=False):
  """The field MLP's bound at `args` (K2, K4a; with `backward` K3, K4b): the
  forward's products, three times as many for a backward (the recomputed
  forward, the W dv products, the weight gradients' contraction over rows);
  each input read once and each output written once. Under 'bf16' every
  product runs on bf16 operands but those the kernels keep fp32: the output
  layer's weight gradient, and row-major its forward h @ W_out."""
  e, _, n = args['h0_groups'][0].shape
  f = sum(g.shape[1] for g in args['h0_groups'])
  width = args['weights'][0].shape[-1]
  params = sum(t.numel() for t in (*args['weights'], *args['biases'],
                                   args['scales_raw'], args['logit']))
  h0 = e * f * n
  # Backward: h0, g and the parameters in; dh0 and their gradients out.
  nbytes = 4 * (2 * (h0 + params) + e * n if backward else h0 + params + e * n)
  flops = (3 if backward else 1) * e * n * mlp_flops_per_row(f, width, depth)
  if precision != 'bf16':
    return bound_ms(flops, nbytes)
  fan_in_out = args['weights'][-1].shape[1]
  fp32_flops = 2 * e * n * fan_in_out * (backward + (layout == 'rows'))
  return bound_ms(fp32_flops, nbytes, bf16_flops=flops - fp32_flops)


def k1_bound(args, precision='f32'):
  """K1's bound at `args`: three products per row and member as large as
  the forward's (the forward, the backward's W dv, and the weight
  gradients' contraction over rows); the inputs read once and every
  gradient written once. Under 'bf16' every product but the output layer's
  weight gradient runs on bf16 operands."""
  weights = args['weights']
  e, f, width = weights[0].shape
  n = args['x_t'].shape[-1]
  ins = [args[k] for k in ('x_t', 'seasonal_t', 'y', 'lsa', 'fs_raw',
                           'scales_raw', 'logit', 'obs_raw')]
  params = [*weights, *args['biases'], *ins[3:]]
  nbytes = 4 * (sum(t.numel() for t in ins + params)
                + sum(t.numel() for t in params) + e)
  flops = 3 * e * n * mlp_flops_per_row(f, width, len(weights) - 1)
  if precision != 'bf16':
    return bound_ms(flops, nbytes)
  fp32_flops = 2 * e * n * weights[-1].shape[1]  # dW_out = lhs_out dv_out^T
  return bound_ms(fp32_flops, nbytes, bf16_flops=flops - fp32_flops)


def _meta(*shape):
  return torch.empty(shape, device='meta')


def field_shapes(members, f, width, depth):
  """Meta tensors of the field MLP's parameters for `members` members."""
  fan_ins = [f] + [width] * depth
  fan_outs = [width] * depth + [1]
  return dict(
      weights=[_meta(members, i, o) for i, o in zip(fan_ins, fan_outs)],
      biases=[_meta(members, o) for o in fan_outs],
      scales_raw=_meta(members, depth + 1), logit=_meta(members))


def k1_args(members, rows, num_inputs, num_seasonal, groups, f, width, depth,
            data_groups=None):
  """Meta tensors of one K1 call: `members` kernel members over `rows` rows
  each, inputs shared by every member or, with `data_groups`, one row set
  per group of members (a VI step's per-surrogate batches)."""
  lead = () if data_groups is None else (data_groups,)
  return dict(
      x_t=_meta(*lead, num_inputs, rows),
      seasonal_t=_meta(*lead, num_seasonal, rows), y=_meta(*lead, rows),
      lsa=_meta(members, num_inputs), fs_raw=_meta(members, groups),
      obs_raw=_meta(members, 3), **field_shapes(members, f, width, depth))


def k2_args(members, rows, f, width, depth):
  """Meta tensors of the field MLP's forward over `rows` rows."""
  return dict(h0_groups=[_meta(members, f, rows)],
              **field_shapes(members, f, width, depth))
