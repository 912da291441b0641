"""The share of the profiled predict stretch in which no operation ran on
the device: 100 x (1 - the union of device operations / the span), both
from the stretch that records the device's activity alone."""


def read(reading, shapes):
  del shapes
  if reading.span_s <= 0 or reading.busy_s <= 0:
    return None
  return 100 * (1 - reading.busy_s / reading.span_s)
