"""The port's CLI trainer against the JAX package's `train`, value for value:
the SDXL full finetune under AdamW8bit.

The last of tests/test_torch_cli_parity.py's cases, run the same way
(`check_case`; its docstring says what is shared, compared and left out),
in a file of its own: JAX's run of it takes ~2.5 minutes on one worker
(the AdamW8bit step's compile), and a file takes one xdist worker.
"""

from tests.test_torch_cli_parity import _grad_mode_on, _one_thread, check_case  # noqa: F401
from tests.test_torch_main import env  # noqa: F401  (a fixture)


def test_cli_matches_jax_train_full_finetune_adamw8bit(env, tmp_path, monkeypatch):  # noqa: F811
    check_case(env, tmp_path, monkeypatch, "sdxl_full_finetune_adamw8bit")
