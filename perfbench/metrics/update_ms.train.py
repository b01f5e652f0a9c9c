"""Optimizer: the device ms a step of the step's update phase (the gradients'
norm and the three-group update), read inside the captured graph: the
program's `TrainStep.phase_ms()` of a step built with `phases=True`, the
mean over the probe's replays (perfbench/probe.py)."""

from perfbench import probe


def read(m):
    return probe.phase_ms(m, "update")
