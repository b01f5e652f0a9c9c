"""Model: the step's share of the card's dense bf16 peak over the window,
model FLOPs an image (counted on the benchmark's reference, perfbench/flops.py)
x images / window seconds / 989 TFLOP/s."""

from perfbench import flops, yardstick


def read(m):
    if m.get("platform") != "gpu":
        return None
    per_image = flops.train_flops_per_image(m["config"], m["mix"])
    return 100.0 * per_image * m["images"] / m["window_s"] / yardstick.PEAK_BF16_FLOPS
