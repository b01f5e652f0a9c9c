"""The port's kernel build on the CPU: which sources it compiles and how a
library is named. Nothing here compiles (there is no nvcc without a card):
the names come from hashing the sources, headers and flags.
"""

import shutil

import pytest

from sd_lora_trainer_tpu_torch.ops import kernels


def test_each_kernel_source_exists_and_the_split_backward_is_gone():
    assert kernels.KERNEL_SOURCES == ("flash_fwd", "flash_bwd", "norm")
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    assert not list(kernels.CSRC.glob("flash_bwd_d*.cu"))


@pytest.mark.parametrize("header", ["flash_common.cuh", "hopper_common.cuh"])
def test_editing_a_shared_header_renames_every_library(tmp_path, monkeypatch, header):
    """A library is named by a hash of its source and every csrc/*.cuh, so an
    edited header rebuilds each kernel instead of loading a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    assert before == {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    assert all(after[name] != before[name] for name in kernels.KERNEL_SOURCES)


def test_editing_one_kernel_renames_only_its_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {name: kernels._lib_path(name) for name in kernels.KERNEL_SOURCES}
    with open(csrc / "flash_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    assert kernels._lib_path("flash_bwd") != before["flash_bwd"]
    assert kernels._lib_path("flash_fwd") == before["flash_fwd"]


# Stands in for nvcc: prints a report naming its last argument (a unit's
# source, or the last object of a link) and writes an empty file where `-o`
# points.
_FAKE_NVCC = """#!/bin/sh
while [ $# -gt 1 ]; do
  if [ "$1" = -o ]; then out=$2; fi
  shift
done
echo "report of $(basename "$1")"
: > "$out"
"""


def test_a_build_keeps_its_ptxas_report_and_a_cached_library_reads_it_back(tmp_path,
                                                                            monkeypatch):
    """The ptxas report (registers, spills) of every translation unit (a
    flash source's one per padded head dim and the dispatch, the norm
    source's LayerNorm and GroupNorm units) is written beside each library, so
    a run that finds the libraries already built still prints it."""
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    kernels.build_kernels()
    want = {name: "".join(f"== {name}.cu {label}\nreport of {name}.cu\n"
                          for label, _ in kernels._units(name))
            for name in kernels.KERNEL_SOURCES}
    for name in kernels.KERNEL_SOURCES:
        assert [label for label, _ in kernels._units(name)] == (
            ["layer", "group"] if name == "norm" else
            [f"dp{dp}" for dp in range(16, 257, 16)] + ["dispatch"])
        lib = kernels._lib_path(name)
        assert lib.is_file()
        assert lib.with_suffix(".ptxas.txt").read_text() == want[name]
    assert kernels.BUILD_LOG == want
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == sorted(
        p.name for name in kernels.KERNEL_SOURCES
        for p in (kernels._lib_path(name), kernels._report_path(kernels._lib_path(name))))

    def no_nvcc(*args, **kwargs):
        raise AssertionError("a cached library was rebuilt")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    kernels.build_kernels()
    assert kernels.BUILD_LOG == want
