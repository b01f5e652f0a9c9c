"""Model, adapters: the device ms a step that the program's
`sdlt.layer.lora` spans own (the LoRA delta, DoRA's norm and the conv
LoRA path: forward, recompute and backward), on the probe's eager step
with the layer spans armed (perfbench/probe.py, perfbench/spans.py)."""

from perfbench import probe


def read(m):
    return probe.span_ms(probe.train(m), "sdlt.layer.lora")
