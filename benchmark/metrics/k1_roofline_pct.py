"""K1's share of its roofline: the frozen `k1_bound` of one training step's
K1 work at the cell's shapes (its kernel members, each over the step's
rows), over the device time of the kernels launched inside the `bench.k1`
range per profiled step."""

from benchmark import roofline


def read(reading, shapes):
  seconds = reading.summary.range_device_s.get('bench.k1', 0.0)
  if seconds <= 0 or reading.units <= 0:
    return None
  args = roofline.k1_args(
      shapes['kernel_members'], shapes['rows'], shapes['num_inputs'],
      shapes['num_seasonal'], shapes['groups'], shapes['f'], shapes['width'],
      shapes['depth'], shapes['data_groups'])
  bound_ms, _ = roofline.k1_bound(args, shapes['precision'])
  return 100 * bound_ms * 1e-3 / (seconds / reading.units)
