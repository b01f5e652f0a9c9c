"""Losses: the device ms a step of the step's loss phase (the diffusion loss,
the token-attention loss and the regularizers), read inside the captured
graph: the program's `TrainStep.phase_ms()` of a step built with
`phases=True`, the mean over the probe's replays (perfbench/probe.py)."""

from perfbench import probe


def read(m):
    return probe.phase_ms(m, "loss")
