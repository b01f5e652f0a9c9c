"""Attention kernels: the flash forward's share of its roofline in the
traced render call: the sum over its launches of each call's bound
(perfbench/yardstick.py, over the model's (query, key) pairs) over the
flash kernels' device time."""

from perfbench import yardstick


def read(m):
    t, calls = m["trace"], m.get("attention_calls")
    return yardstick.flash_roofline_pct(t, calls) if t is not None and calls else None
