"""Device milliseconds per training step in operations launched outside
K1's call (`bench.k1`): the prior, Adam, the batch gather, VI's draws and
log q."""


def read(reading, shapes):
  del shapes
  summary = reading.summary
  if reading.units <= 0 or summary.device_s <= 0:
    return None
  other = summary.device_s - summary.range_device_s.get('bench.k1', 0.0)
  return 1e3 * other / reading.units
