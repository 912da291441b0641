"""Device milliseconds per predict call in operations launched outside
K2's call (`bench.k2`): the encode, the summaries and the mixture
quantiles' root-find."""


def read(reading, shapes):
  del shapes
  summary = reading.summary
  if reading.units <= 0 or summary.device_s <= 0:
    return None
  other = summary.device_s - summary.range_device_s.get('bench.k2', 0.0)
  return 1e3 * other / reading.units
