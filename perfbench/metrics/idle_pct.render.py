"""Render: the share of a traced render call in which no operation ran on
the device (the union of the device's intervals). The render is eager, so
this is how far host dispatch holds the card back (the profiler's own host
cost included)."""

from perfbench import yardstick


def read(m):
    return None if m["trace"] is None else yardstick.idle_pct(m["trace"])
