"""The benchmark's own tests, on the CPU at the tiny sizes (the card's run
is marked `cuda` and skips elsewhere).

    python -m pytest perfbench/tests -q
"""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import check, harness, yardstick
from perfbench.harness import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TRAIN_CELLS = [c for c in CELLS if c != "sdxl_render_1024_n6"]


def _run(workload, *extra, seed=5, trace=1):
    cmd = [sys.executable, str(ROOT / "perfbench/run.py"), "--workload", workload, "--seed",
           str(seed), "--seconds", "1", "--trace", str(trace), *extra]
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=600)


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_runs_tiny_on_the_cpu(workload):
    """The whole path of a run, the check included, at the tiny sizes; the
    process that prints the result loaded neither JAX nor the JAX package
    (the harness exits 3 if it did)."""
    out = _run(workload, "--device", "cpu", "--tiny", "1", seed=2**31 + 12345)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    # the check's numbers are the last lines of stderr
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_a_card_no_result():
    out = _run(CELLS[0], trace=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_reference_and_benchmark_load_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r);"
            "import perfbench.check, perfbench.flops, perfbench.reference.train;"
            "tops = {m.split('.')[0] for m in sys.modules};"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'sd_lora_trainer_tpu',"
            " 'sd_lora_trainer_tpu_torch'}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sd_lora_trainer_tpu_torch_x", sys)
    assert "sd_lora_trainer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("case", [
    # shape, forward bound (s), backward bound (s): PERF.md's kernel table
    ((4, 10, 4096, 64), 171.80e9, 429.50e9),
    ((4, 20, 1024, 64), 21.475e9, 53.687e9),
])
def test_flash_work_hand_counts(case):
    (b, h, l, d), fwd_flops, bwd_flops = case
    f, nbytes = yardstick.flash_work("fwd", b, h, l, d)
    assert f == pytest.approx(4 * b * h * l * l * d) == pytest.approx(fwd_flops, rel=1e-3)
    assert nbytes == 4 * (b * h * l * d * 2) + b * h * l * 4
    fb, nb = yardstick.flash_work("bwd", b, h, l, d)
    assert fb == pytest.approx(bwd_flops, rel=1e-3)
    assert nb == 7 * (b * h * l * d * 2) + 2 * b * h * l * 4
    assert yardstick.bound_s(f, nbytes) == pytest.approx(f / 989e12)


def test_bytes_bound_a_short_call():
    f, nbytes = yardstick.flash_work("fwd", 4, 8, 256, 160)
    assert yardstick.bound_s(f, nbytes) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("shape", [(2, 3, 40, 8), (1, 2, 64, 16)])
def test_flop_convention_counts_attention_once(shape):
    """The reference's plain attention counts 4 B H L^2 d forward and twice
    that backward under FlopCounterMode: the model's work, no recompute."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference.nn import Prec, self_attention

    b, h, l, d = shape
    q, k, v = (torch.randn(b, h, l, d, requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as c:
        out = self_attention(q, k, v, Prec("fp32", plain=True))
        out.sum().backward()
    assert c.get_total_flops() == 12 * b * h * l * l * d


def test_sdxl_step_flops_match_the_program_count():
    """14.670 TF an image at 1024px (the program's own count: 14.669)."""
    from perfbench import flops

    config = json.loads((ROOT / "perfbench/configs/sdxl_base.json").read_text())
    mix = json.loads((ROOT / "perfbench/traffic/style_1024_bs4.json").read_text())
    assert flops.train_flops_per_image(config, mix) == pytest.approx(14.669e12, rel=1e-4)


def test_attention_calls_of_both_models():
    sdxl = json.loads((ROOT / "perfbench/configs/sdxl_base.json").read_text())["unet"]
    calls = yardstick.self_attention_calls(sdxl, 4, 128, 128)
    assert len(calls) == 70
    assert calls.count((4, 10, 4096, 64)) == 10 and calls.count((4, 20, 1024, 64)) == 60
    sd15 = json.loads((ROOT / "perfbench/configs/sd15_base.json").read_text())["unet"]
    calls = yardstick.self_attention_calls(sd15, 4, 96, 96)
    assert sorted(set(calls)) == [(4, 8, 576, 160), (4, 8, 2304, 80), (4, 8, 9216, 40)]
    assert len(calls) == 15


def test_idle_share_counts_overlaps_once():
    t = yardstick.Trace(device=[("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 2.5, 2.7),
                                ("d", 5.0, 6.0), ("e", 9.0, 12.0)],
                        host=[("step", 0.0, 10.0), ("host_batch", 3.0, 5.0)], window=(0.0, 10.0))
    assert t.busy_s() == pytest.approx(3.0 + 1.0 + 1.0)
    assert t.idle_gaps() == [(3.0, 5.0), (6.0, 9.0)]
    assert t.gap_causes() == {"host_batch": pytest.approx(2.0), "step": pytest.approx(3.0)}
    assert sum(t.by_name().values()) == pytest.approx(2.0 + 2.0 + 0.2 + 1.0 + 1.0)


def test_kernel_families():
    assert yardstick.kernel_family("void flash_fwd_kernel<64>(FlashArgs)") == "flash"
    assert yardstick.kernel_family("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    assert yardstick.kernel_family("cudnn::engines_precompiled::conv2d_fprop") == "conv"
    assert yardstick.kernel_family("void at::native::vectorized_elementwise_kernel<4, "
                                   "{lambda()#3}>") == "other"


def test_leaf_gaps_use_the_median_leaf_for_small_leaves():
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.full((4,), 1e-6)}
    prog = {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.zeros(4)}
    # c's gap, 2e-6, is measured against the median leaf's norm, 2
    assert check.leaf_gaps(prog, ref) == pytest.approx({"a": 0.0, "b": 0.0, "c": 2e-6 / 2.0})
    assert max(check.leaf_gaps({**prog, "b": torch.ones(4)}, ref).values()) == pytest.approx(0.5)


def test_flash_roofline_times_every_kernel_of_the_wrappers():
    """A backward call is two kernels (the fused one and dq's conversion):
    both count in its time, the fused one alone in the launches."""
    call = (4, 10, 4096, 64)
    bound = {k: yardstick.bound_s(*yardstick.flash_work(k, *call)) for k in ("fwd", "bwd")}
    dev = [("void flash_fwd_kernel<bf16, 64>(FlashArgs)", 0.0, bound["fwd"] * 2),
           ("void flash_bwd_kernel<bf16, 64>(BwdParams)", 1.0, 1.0 + bound["bwd"] * 2),
           ("void flash_bwd_dq_convert_kernel<bf16>(float const*)", 2.0, 2.0 + bound["bwd"] * 2),
           ("void at::native::elementwise_kernel<128, 4>", 3.0, 3.5)]
    trace = yardstick.Trace(device=dev, host=[], window=(0.0, 4.0))
    total = bound["fwd"] + bound["bwd"]
    time = 2 * bound["fwd"] + 4 * bound["bwd"]
    assert yardstick.flash_roofline_pct(trace, [call]) == pytest.approx(100.0 * total / time)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(workload, seed=3, trace=0)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
