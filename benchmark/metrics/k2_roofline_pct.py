"""K2's share of its roofline: the frozen `field_mlp_bound` of the field
MLP's forward over every member and grid row of one predict call, over the
device time of the kernels launched inside the `bench.k2` range per
profiled call."""

from benchmark import roofline


def read(reading, shapes):
  seconds = reading.summary.range_device_s.get('bench.k2', 0.0)
  if seconds <= 0 or reading.units <= 0:
    return None
  args = roofline.k2_args(shapes['members'], shapes['rows'], shapes['f'],
                          shapes['width'], shapes['depth'])
  bound_ms, _ = roofline.field_mlp_bound(args, shapes['depth'],
                                         shapes['precision'])
  return 100 * bound_ms * 1e-3 / (seconds / reading.units)
