"""Model, norms: the device ms a step that the program's `sdlt.layer.norm`
spans own (group_norm and layer_norm: forward, recompute and, through each
backward node's forward op, backward), on the probe's eager step with the
layer spans armed (perfbench/probe.py, perfbench/spans.py)."""

from perfbench import probe


def read(m):
    return probe.span_ms(probe.train(m), "sdlt.layer.norm")
