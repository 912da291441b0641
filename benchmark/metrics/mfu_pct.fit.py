"""The whole training step's share of the card's fp32 peak: three field-MLP
passes (forward, W dv, weight gradients) per kernel member and row of a
step, times the steps of the untraced window, over its length, over
`PEAK_FP32_FLOPS`. Read in a traced run whose stretches ran on the
device."""

from benchmark import roofline


def read(reading, shapes):
  if reading.busy_s <= 0 or reading.window_s <= 0:
    return None
  flops = 3 * shapes['kernel_members'] * shapes['rows'] * (
      roofline.mlp_flops_per_row(shapes['f'], shapes['width'],
                                 shapes['depth']))
  return (100 * flops * reading.window_units / reading.window_s
          / roofline.PEAK_FP32_FLOPS)
