"""The whole predict call's share of the card's fp32 peak: one field-MLP
forward per member and grid row, times the calls of the untraced window,
over its length, over `PEAK_FP32_FLOPS`. Read in a traced run whose
stretches ran on the device."""

from benchmark import roofline


def read(reading, shapes):
  if reading.busy_s <= 0 or reading.window_s <= 0:
    return None
  flops = shapes['members'] * shapes['rows'] * roofline.mlp_flops_per_row(
      shapes['f'], shapes['width'], shapes['depth'])
  return (100 * flops * reading.window_units / reading.window_s
          / roofline.PEAK_FP32_FLOPS)
