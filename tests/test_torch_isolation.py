"""The port and chip_smoke.py import neither jax nor the JAX package.

Checked twice: in a fresh interpreter that imports every module of the port
(parallel/ included: it uses torch.distributed, never jax.distributed)
and chip_smoke.py (sys.modules must then hold no jax, no
sd_lora_trainer_tpu and no safetensors), and by scanning their sources'
import statements. The port builds only sources of its own csrc/ (the
flash kernels, the C++ tokenizer), never the root csrc/ of the JAX package.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "sd_lora_trainer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sd_lora_trainer_tpu", "safetensors", "pandas")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_exist():
    mods = _port_modules()
    for name in ("ops.flash_attention", "models.unet", "training.step", "interop", "config",
                 "models.vae", "models.synthesize", "models.tokenizer", "models.tokenizer_native",
                 "data.preprocess", "data.dataset", "data.bucketing", "data.io",
                 "data.captioners", "data.face_masks", "data.super_resolution",
                 "inference", "main", "utils.utils", "utils.val_prompts", "utils.plots",
                 "training.prodigy", "training.quantized_adam", "training.token_warmup",
                 "predict", "node", "comfyui_init", "parallel.sharding",
                 "parallel.distributed", "bench", "utils.profiling",
                 "diffusion.experimental_losses", "diffusion.daam_debug", "scripts",
                 "scripts.bench_inference", "scripts.profile_step", "scripts.convergence_run",
                 "scripts.plan_trace_check", "scripts.real_weights_check",
                 "scripts.render_checkpoint", "scripts.auto_eval_model"):
        assert f"sd_lora_trainer_tpu_torch.{name}" in mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_native_sources_are_the_ports_own():
    from sd_lora_trainer_tpu_torch.models import tokenizer_native
    from sd_lora_trainer_tpu_torch.ops import kernels

    csrc = PORT / "csrc"
    assert tokenizer_native.SRC.resolve().parent == csrc and tokenizer_native.SRC.exists()
    assert kernels.CSRC.resolve() == csrc
    assert all((csrc / f"{name}.cu").exists() for name in kernels.KERNEL_SOURCES)
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert '"..", "..", "csrc"' not in text and "parents[2] / \"csrc\"" not in text, path
