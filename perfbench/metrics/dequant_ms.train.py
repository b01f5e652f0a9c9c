"""Model, int8 base: the device ms a step that the program's
`sdlt.layer.dequant` spans own (the int8 base weights' dequantization,
`QTensor.to`, in the forward and in remat's recompute), on the probe's
eager step with the layer spans armed (perfbench/probe.py,
perfbench/spans.py)."""

from perfbench import probe


def read(m):
    return probe.span_ms(probe.train(m), "sdlt.layer.dequant")
