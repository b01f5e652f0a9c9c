"""The span attribution (perfbench/spans.py), the probe (perfbench/probe.py)
and the readers of the program's spans and phase marks, on the CPU.

    python -m pytest perfbench/tests -q
"""

import json

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, probe, spans
from perfbench.harness import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["cond_ms.train", "unet_fwd_ms.train", "loss_ms.train", "backward_ms.train",
       "update_ms.train", "norm_ms.train", "lora_ms.train", "dequant_ms.train",
       "decode_ms.render", "write_ms.render"]


@pytest.fixture(autouse=True)
def _grad_mode_on():
    with torch.enable_grad():
        yield


def _reader(name):
    return harness.load_module(HERE / "metrics" / f"{name}.py",
                               "perfbench_metric_" + name.replace(".", "_"))


def _within(ev, outer):
    s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    return any(o.start_ns() <= s and e <= o.start_ns() + o.duration_ns() for o in outer)


def test_cpu_run_attributes_backward_ops_to_the_forward_span():
    """CPU ops stand in for kernels: the group_norm's forward and its
    backward node's ops belong to the span the forward ran in; the multiply
    after it, forward and backward, to none."""
    x = torch.randn(2, 8, 4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("sdlt.layer.norm"):
            y = F.group_norm(x, 4)
        (y * 3.0).sum().backward()
    events = list(prof.profiler.kineto_results.events())
    owned = list(spans.owners(events, cpu_ops=True))
    gn_bwd = [e for e in events if e.name() == "NativeGroupNormBackward0"]
    mul_bwd = [e for e in events if e.name() == "MulBackward0"]
    assert gn_bwd and mul_bwd
    in_gn_bwd = [name for e, name in owned if _within(e, gn_bwd)]
    assert in_gn_bwd and set(in_gn_bwd) == {"sdlt.layer.norm"}
    in_mul_bwd = [name for e, name in owned if _within(e, mul_bwd)]
    assert in_mul_bwd and set(in_mul_bwd) == {spans.NONE}
    mul = [e for e in events if e.name() == "aten::mul" and not _within(e, mul_bwd)]
    assert {name for e, name in owned if _within(e, mul)} == {spans.NONE}
    total = spans.attribute(prof, cpu_ops=True)
    assert set(total) == {"sdlt.layer.norm", spans.NONE}
    assert total["sdlt.layer.norm"] > 0 and total[spans.NONE] > 0
    assert spans.host_seconds(events, "sdlt.layer.norm") > 0


class _NoKind:
    """A profiler event as torch 2.11 gives it: no activity type."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return getattr(self._e, name)


def test_events_without_an_activity_type_attribute_alike():
    x = torch.randn(2, 8, 4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("sdlt.layer.norm"):
            y = F.group_norm(x, 4)
        (y * 3.0).sum().backward()
    events = list(prof.profiler.kineto_results.events())
    plain = [name for _, name in spans.owners(events, cpu_ops=True)]
    assert plain == [name for _, name in spans.owners([_NoKind(e) for e in events], cpu_ops=True)]


def test_innermost_span_wins():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("sdlt.step.loss"):
            a = x @ x
            with record_function("sdlt.layer.lora"):
                b = a @ x
    del b
    events = list(prof.profiler.kineto_results.events())
    inner = [e for e in events if e.name() == "sdlt.layer.lora"]
    owned = list(spans.owners(events, cpu_ops=True))
    assert {name for e, name in owned if _within(e, inner)} == {"sdlt.layer.lora"}
    assert {name for e, name in owned if not _within(e, inner)} == {"sdlt.step.loss"}


def test_new_metrics_are_declared_at_the_end():
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-len(NEW):] == NEW
    for m in BENCH["per_layer"][-len(NEW):]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["unit"] == "ms" and m["better"] == "lower"


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_their_input(name):
    m = {"platform": "cpu", "trace": None, "config": {}, "mix": {}}
    assert _reader(name).read(m) is None


@pytest.mark.parametrize("name", NEW[:-1])
def test_readers_leave_a_program_without_spans_alone(name, monkeypatch):
    """On the card, against a program whose step takes no phase marks (an
    older one), the probe builds nothing."""
    monkeypatch.setattr(probe, "_armed_program", lambda: False)

    def no_build(*a, **kw):
        raise AssertionError("the probe ran")

    monkeypatch.setattr(probe, "train_probe", no_build)
    monkeypatch.setattr(probe, "render_probe", no_build)
    assert _reader(name).read({"platform": "gpu", "trace": None, "config": {}, "mix": {}}) is None


def test_write_ms_reads_the_traced_calls_span():
    from perfbench.yardstick import Trace

    read = _reader("write_ms.render").read
    t = Trace(device=[("k", 0.0, 1.0)], host=[("sdlt.render.write", 1.0, 1.25),
                                              ("aten::mm", 0.0, 0.5)], window=(0.0, 2.0))
    assert read({"trace": t}) == pytest.approx(250.0)
    t.host = t.host[1:]
    assert read({"trace": t}) is None


def test_run_seed_from_the_command_line():
    assert probe.run_seed(["run.py", "--workload", "w", "--seed", "2147495992"]) == 2147495992
    assert probe.run_seed(["run.py", "--seed=7"]) == 7
    assert probe.run_seed(["run.py"]) == 0


def test_train_probe_on_the_cpu():
    """The probe's whole path at the tiny sizes: the eager step's host ops by
    span (the device's phase marks exist on the card only)."""
    _, _, config, mix = harness.load_cell("sdxl_style_1024_bs4", tiny=True)
    torch.set_num_threads(2)
    p = probe.train_probe(config, mix, 2**31 + 5, torch.device("cpu"))
    assert p["phase_ms"] is None and p["armed_replay_s"] is None
    owned = set(p["span_s"])
    assert {"sdlt.layer.norm", "sdlt.layer.lora", "sdlt.layer.dequant"} <= owned
    assert {"sdlt.step.conditioning", "sdlt.step.unet_forward", "sdlt.step.loss",
            "sdlt.step.update.unet"} <= owned


def test_render_probe_on_the_cpu():
    _, _, config, mix = harness.load_cell("sdxl_render_1024_n6", tiny=True)
    torch.set_num_threads(2)
    p = probe.render_probe(config, mix, 11, torch.device("cpu"))
    assert "sdlt.render.decode" in p["span_s"] and "sdlt.render.denoise" in p["span_s"]
    assert set(p["host_s"]) >= {"sdlt.render.encode", "sdlt.render.denoise",
                                "sdlt.render.decode", "sdlt.render.write"}
