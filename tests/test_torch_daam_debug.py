"""The port's DAAM heatmap stacking and debug plot against the JAX package's.

`stack_attention_maps` on the same per-layer scores (three layers of
different lengths, numpy inputs from a seed) at img_ratio 1.0 and
1216/832: the stacked [L, B, h, w, 77] maps within 1e-5 of the largest
(float32; the bicubic resize is a weight matrix per axis on both sides).
`plot_token_attention_maps` writes a PNG where matplotlib exists and
returns "" where it cannot be imported, as the JAX function does.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.diffusion.daam_debug import plot_token_attention_maps as j_plot
from sd_lora_trainer_tpu.diffusion.losses import stack_attention_maps as j_stack
from sd_lora_trainer_tpu_torch.diffusion import daam_debug
from sd_lora_trainer_tpu_torch.diffusion.losses import stack_attention_maps

TOL = 1e-5
# (img_ratio, the layers' (h, w)): w / h is the ratio
LAYOUTS = {
    "square": (1.0, [(8, 8), (16, 16), (32, 32)]),
    "bucket_832x1216": (1216 / 832, [(13, 19), (26, 38), (52, 76)]),
}


def _scores(shapes, seed=0, batch=2):
    rs = np.random.RandomState(seed)
    return {f"up.{i}.attn2": rs.randn(batch, h * w, 77).astype(np.float32)
            for i, (h, w) in enumerate(reversed(shapes))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stack_attention_maps_matches_jax(layout):
    ratio, shapes = LAYOUTS[layout]
    scores = _scores(shapes)
    want = np.asarray(j_stack({k: jnp.asarray(v) for k, v in scores.items()}, ratio))
    got = stack_attention_maps({k: torch.from_numpy(v) for k, v in scores.items()}, ratio)
    h, w = shapes[0]
    assert tuple(got.shape) == want.shape == (3, 2, h, w, 77)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), err


def test_stack_attention_maps_refuses_a_length_the_ratio_does_not_factor():
    scores = {"a": torch.zeros(1, 100, 77), "b": torch.zeros(1, 99, 77)}
    with pytest.raises(ValueError, match="does not factor"):
        stack_attention_maps(scores, 1.0)


def test_plot_writes_a_png(tmp_path):
    ratio, shapes = LAYOUTS["bucket_832x1216"]
    scores = _scores(shapes, seed=1)
    h, w = shapes[-1]
    masks = np.ones((2, h, w, 1), np.float32)
    positions = np.array([[1, 2, 3], [1, 2, -1]])
    out = daam_debug.plot_token_attention_maps(str(tmp_path / "t"), scores, masks, positions,
                                               ratio, global_step=7)
    want = j_plot(str(tmp_path / "j"), scores, masks, positions, ratio, global_step=7)
    assert out == str(tmp_path / "t" / "daam" / "token_attention_00007.png")
    assert os.path.getsize(out) > 0 and os.path.basename(want) == os.path.basename(out)


def test_plot_returns_empty_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` raises
    ratio, shapes = LAYOUTS["square"]
    out = daam_debug.plot_token_attention_maps(
        str(tmp_path), _scores(shapes), np.ones((2, 8, 8, 1), np.float32),
        np.array([[1, 2, 3], [1, 2, 3]]), ratio, global_step=0)
    assert out == "" and not os.path.exists(tmp_path / "daam")
