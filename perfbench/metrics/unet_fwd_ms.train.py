"""Model, UNet: the device ms a step of the step's UNet forward phase (the
draws, add_noise and the UNet's forward), read inside the captured graph:
the program's `TrainStep.phase_ms()` of a step built with `phases=True`,
the mean over the probe's replays (perfbench/probe.py)."""

from perfbench import probe


def read(m):
    return probe.phase_ms(m, "unet_forward")
