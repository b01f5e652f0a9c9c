"""Step and graph: the share of the traced steps' window in which no
operation ran on the device (the union of the device's intervals, not a
sum of kernel times, so overlapping kernels count once)."""

from perfbench import yardstick


def read(m):
    return None if m["trace"] is None else yardstick.idle_pct(m["trace"])
