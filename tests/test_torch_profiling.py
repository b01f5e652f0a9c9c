"""The port's profiling and FLOP-counting helpers (utils/profiling.py), and
the flash ops' backward op and FLOP formulas (ops/flash_attention.py).

- `trace_steps` writes a Chrome trace on the CPU; an exception in its body
  comes out unchanged (the JAX version yields twice and reports it as a
  failed trace instead); disabled, it writes nothing;
- `device_time_table` splits synthetic kernels by family, and an exported
  trace of the same kernels (`trace_kernels`) gives the same table;
- `ThroughputMeter`, the peak table, `print_system_info`;
- the flash ops under FakeTensorMode: 4 B H pairs d forward and 8 B H pairs
  d backward, pairs the real tokens' (`valid_len`); on CPU tensors the
  flash op's forward and backward count what FlopCounterMode counts for
  plain attention's matmuls over the real tokens; the backward op on CPU
  tensors equals the plain `flash_bwd_ref`, bit for bit;
- `count_step_flops` on tiny SDXL: a batch of 2 counts twice a batch of 1,
  and the same as the bench's 1-row count times 2.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
from sd_lora_trainer_tpu_torch.utils import profiling
from sd_lora_trainer_tpu_torch.utils.utils import print_system_info


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


class _BodyError(Exception):
    pass


def test_trace_steps_writes_a_chrome_trace(tmp_path):
    with profiling.trace_steps(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "") for e in events)
    assert profiling.trace_kernels(str(tmp_path / "profile" / "trace.json")) == []  # no card


def test_trace_steps_lets_the_body_error_through(tmp_path):
    err = _BodyError("in the traced block")
    with pytest.raises(_BodyError) as info:
        with profiling.trace_steps(str(tmp_path)):
            raise err
    assert info.value is err


def test_trace_steps_disabled_writes_nothing(tmp_path):
    with profiling.trace_steps(str(tmp_path), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "profile").exists()


SYNTHETIC = [
    ("void flash_fwd_kernel<64>(FlashArgs)", 8000.0, 70),
    ("void flash_bwd_kernel<64>(FlashArgs)", 21000.0, 70),
    ("flash_bwd_dq_convert_kernel", 1500.0, 70),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 90000.0, 900),
    ("nvjet_tst_128x256_64x4", 34000.0, 400),
    ("cudnn::engines_precompiled::implicit_convolveNd_sgemm", 26000.0, 120),
    ("void at::native::vectorized_elementwise_kernel<4>", 60000.0, 15000),
    ("Memcpy HtoD (Pageable -> Device)", 500.0, 3),
]


def test_device_time_table_splits_by_family():
    table = profiling.device_time_table(SYNTHETIC, top=3)
    assert table.family_ms == pytest.approx({"flash": 30.5, "conv": 26.0, "gemm": 124.0,
                                             "other": 60.5})
    assert table.device_s == pytest.approx(0.241)
    assert table.kernels == sum(n for _, _, n in SYNTHETIC)
    assert set(table.flash_ms) == {k for k, _, _ in SYNTHETIC[:3]}
    assert [k for k, _ in table.top_ms] == [SYNTHETIC[3][0], SYNTHETIC[6][0], SYNTHETIC[4][0]]
    assert len(table.lines()) == 3 and table.lines()[0].startswith("[profile] 16633 device kernels")


def test_flash_launches_from_kernel_names():
    """A flash wrapper's launches are its main kernel's count in the
    profile; flash_bwd's dQ conversion is not a second launch."""
    table = profiling.device_time_table(SYNTHETIC)
    assert table.flash_launches == {"flash_fwd": 70, "flash_bwd": 70}
    assert profiling.device_time_table(SYNTHETIC[3:]).flash_launches == {"flash_fwd": 0,
                                                                         "flash_bwd": 0}


class _Event:
    """The methods of a raw profiler event (torch's _KinetoEvent) that
    `device_kernels` reads."""

    def __init__(self, name, us, device_type, annotation=False):
        self._name, self._ns, self._type, self._annotation = name, us * 1e3, device_type, annotation

    def name(self):
        return self._name

    def duration_ns(self):
        return self._ns

    def device_type(self):
        return self._type

    def is_user_annotation(self):
        return self._annotation


class _Prof:
    """A profiler whose kineto results hold the given raw events."""

    def __init__(self, events):
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: events))


def test_device_kernels_keep_lambda_named_kernels():
    """PyTorch's elementwise and copy kernels carry '#' in their names
    ({lambda()#3}); they are device work like any other. User annotations
    and CPU events are not."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    copy = "void at::native::unrolled_elementwise_kernel<{lambda()#3}::operator()>"
    prof = _Prof([_Event(copy, 100.0, cuda), _Event("nvjet_tst_320x128", 100.0, cuda),
                  _Event(copy, 18.0, cuda),
                  _Event("Optimizer.step#AdamW.step", 300.0, cuda, annotation=True),
                  _Event("aten::copy_", 50.0, cpu), _Event("idle_kernel", 0.0, cuda)])
    assert profiling.device_kernels(prof) == [(copy, 118.0, 2), ("nvjet_tst_320x128", 100.0, 1)]


def test_device_kernels_of_a_real_profiler_run():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert profiling.device_kernels(prof) == []  # CPU ops only, no card here


def test_an_exported_trace_gives_the_same_table(tmp_path):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 99.0}]
    ts = 0.0
    for name, us, n in SYNTHETIC:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        for _ in range(n):
            events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": us / n})
            ts += us / n
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.device_time_table(profiling.trace_kernels(str(path)))
    want = profiling.device_time_table(SYNTHETIC)
    assert got.kernels == want.kernels
    assert got.family_ms == pytest.approx(want.family_ms, rel=1e-9)


def test_throughput_meter(monkeypatch):
    clock = iter([10.0, 12.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = profiling.ThroughputMeter()
    meter.update(4)
    meter.update(4)
    assert meter.images == 8 and meter.imgs_per_sec == pytest.approx(4.0)


def test_peaks_by_device_name():
    assert profiling.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert profiling.peak_bf16_flops("NVIDIA H100 PCIe") is None
    assert profiling.peak_bf16_flops("cpu") is None
    assert profiling.device_description(torch.device("cpu")) == "cpu"


def test_print_system_info(capsys):
    print_system_info()
    out = capsys.readouterr().out
    assert "Disk:" in out and "RAM:" in out and "Device:" not in out  # no card here


@pytest.mark.parametrize("valid_len", [0, 1000])
@pytest.mark.parametrize("stash8", [False, True])
def test_flash_flop_formulas_on_fake_tensors(valid_len, stash8):
    b, h, length, d = 2, 3, 1024, 64
    op = fa.flash_attention_stash8 if stash8 else fa.flash_attention
    with FakeTensorMode():
        q, k, v = (torch.empty(b, h, length, d, dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        with FlopCounterMode(display=False) as counter:
            out = op(q, k, v, 0.125, valid_len)
            if not stash8:
                out[0].sum().backward()
    pairs = (valid_len or length) ** 2
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    fwd = "sd_lora_torch.flash_attention_stash8" if stash8 else "sd_lora_torch.flash_attention"
    assert counts[fwd] == 4 * b * h * pairs * d
    if not stash8:
        assert counts["sd_lora_torch.flash_attention_backward"] == 8 * b * h * pairs * d


def _plain_attention(q, k, v, sm_scale):
    return torch.softmax(q @ k.transpose(-1, -2) * sm_scale, dim=-1) @ v


@pytest.mark.parametrize("valid_len", [0, 300])
def test_flash_flops_equal_plain_attentions_matmuls(valid_len):
    """The flash op's forward and backward, run on CPU tensors (its plain
    version), count what FlopCounterMode counts for the matmuls of plain
    softmax(QK^T)V and its autograd backward over the real tokens: the
    padded rows and keys above `valid_len` are no model work."""
    b, h, length, d = 1, 2, 384, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, length, d, generator=g).requires_grad_() for _ in range(3))

    def counted(fn):
        with FlopCounterMode(display=False) as counter:
            fn().sum().backward()
        return counter.get_total_flops()

    n = valid_len or length
    flash = counted(lambda: fa.flash_attention(q, k, v, 0.125, valid_len)[0])
    plain = counted(lambda: _plain_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n], 0.125))
    assert plain == 12 * b * h * n * n * d  # 2 matmuls forward, 4 backward
    assert flash == plain


def test_backward_op_equals_the_plain_backward():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 384, 64, generator=g) for _ in range(4))
    o, lse = fa.flash_fwd_ref(q, k, v, 0.125, 300)
    di = (o * do).sum(-1)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, 0.125, 300)
    want = fa.flash_bwd_ref(q, k, v, do, lse, di, 0.125, 300)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _tiny_step(batch_size):
    from sd_lora_trainer_tpu_torch import bench

    run = bench.setup(bench.Levers.from_env({
        "BENCH_TINY": "1", "BENCH_PLATFORM": "cpu", "BENCH_RES": "64",
        "BENCH_BS": str(batch_size)}))
    batch = run.batch(8, 8, np.random.RandomState(0))
    return run, batch


def test_count_step_flops_is_linear_in_the_batch():
    from sd_lora_trainer_tpu_torch import bench

    run, batch = _tiny_step(2)
    two = profiling.count_step_flops(run.sc, run.state.trainable, run.frozen,
                                     {k: (v[0] if v.ndim else v) for k, v in batch.items()})
    one = profiling.count_step_flops(run.sc, run.state.trainable, run.frozen,
                                     {k: (v[0, :1] if v.ndim else v) for k, v in batch.items()})
    assert one > 0 and two == 2 * one
    assert bench.step_flops(run, batch) == two
    assert all(t.grad is None for t in run.state.optimizer.params())
    # remat plans recompute, but the count is the model's: the same under any plan
    run.sc = dataclasses.replace(run.sc, remat=True)
    assert bench.step_flops(run, batch) == two
