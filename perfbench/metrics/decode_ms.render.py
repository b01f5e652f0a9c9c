"""Render, VAE: the device ms of a render call that the program's
`sdlt.render.decode` span owns (the VAE decode and the images' copy to
the host), on the probe's profiled call (perfbench/probe.py,
perfbench/spans.py)."""

from perfbench import probe


def read(m):
    return probe.span_ms(probe.render(m), "sdlt.render.decode")
