"""Host-side pieces of the CUDA kernels that run without a card: the
stream, pair and dot wrappers' CPU path, the build hash over the shared
headers (csrc/staging.cuh, csrc/lanes.cuh, csrc/async_copy.cuh,
csrc/mma_tf32.cuh), and the compiler-log names of the redesigned
kernels."""

import os
import re
import shutil

import pytest
import torch

from dgen_tpu_torch.ops import _build
from dgen_tpu_torch.ops import billkernels as bk

ALL_DTYPES = bk.IMPORT_DTYPES + bk.SIGNED_DTYPES


@pytest.mark.parametrize("dtypes", ALL_DTYPES, ids=lambda d: "-".join(
    str(t).replace("torch.", "") for t in d))
def test_stream_and_pair_wrappers_run_the_plain_version_on_the_cpu(dtypes):
    """On CPU tensors the wrappers return their plain version bit for bit,
    at its output dtype, and count no kernel launch."""
    g = torch.Generator().manual_seed(7)

    def stream(dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, (3, 8760), generator=g,
                                 dtype=torch.int8)
        return torch.rand((3, 8760), generator=g).to(dtype)

    load, gen, sell, sell_b = (stream(d) for d in (*dtypes, dtypes[2]))
    period = torch.randint(-1, 4, (3, 8760), generator=g, dtype=torch.int32)
    period_b = torch.randint(0, 3, (3, 8760), generator=g, dtype=torch.int32)
    scales = torch.rand((3, 5), generator=g)
    before = dict(bk.LAUNCHES)
    signed = dtypes in bk.SIGNED_DTYPES
    args = (load, gen, sell, period, scales, bk.FULL_OFFSETS, 3, signed)
    got = bk.stream_sums(*args)
    ref = bk.month_sums_plain(*args)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, ref, strict=True))
    if dtypes in bk.IMPORT_DTYPES:
        pair = (load, gen, sell, period, sell_b, period_b, scales,
                bk.FULL_OFFSETS, 3)
        got = bk.month_pair_sums(*pair)
        ref = bk.month_pair_sums_plain(*pair)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, ref, strict=True))
    assert bk.LAUNCHES == before


@pytest.mark.parametrize("dtypes", ALL_DTYPES, ids=lambda d: "-".join(
    str(t).replace("torch.", "") for t in d))
def test_dot_wrapper_runs_the_plain_version_on_the_cpu(dtypes):
    """On CPU tensors the dot wrapper returns its plain version bit for
    bit, at its output dtype, and counts no kernel launch."""
    g = torch.Generator().manual_seed(8)

    def stream(dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, (3, 8760), generator=g,
                                 dtype=torch.int8)
        return torch.rand((3, 8760), generator=g).to(dtype)

    load, gen, sell = (stream(d) for d in dtypes)
    period = torch.randint(0, 3, (3, 8760), generator=g, dtype=torch.int32)
    scales = torch.rand((3, 5), generator=g)
    before = dict(bk.LAUNCHES)
    args = (load, gen, sell, bk.hourly_bucket_ids(period, 3), scales, 3,
            dtypes in bk.SIGNED_DTYPES)
    got = bk.dot_sums(*args)
    ref = bk.dot_sums_plain(*args)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, ref, strict=True))
    assert bk.LAUNCHES == before


def _included_headers() -> list[str]:
    found = set()
    for src in _build.sources():
        with open(src) as f:
            found.update(re.findall(r'^#include "([^"]+)"', f.read(), re.M))
    return sorted(found)


def test_every_included_header_is_in_csrc():
    headers = _included_headers()
    assert {"async_copy.cuh", "lanes.cuh", "mma_tf32.cuh", "staging.cuh"} <= set(headers)
    for h in headers:
        assert os.path.isfile(os.path.join(_build.CSRC, h)), h


@pytest.mark.parametrize("header", _included_headers())
def test_library_path_covers_every_included_header(header, tmp_path, monkeypatch):
    """The build hash reads every file of csrc/, so an edit to any header
    a kernel source includes rebuilds the library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build.library_path()
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_kernel_resources_name_the_dot_kernel_forms():
    pre = "_ZN46_GLOBAL__N__2b7c3a41_18_bucket_sums_dot_cu_5e1c4a2b"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{pre}{name}{targs}EEvPKT1_' "
        "for 'sm_90a'" for name, targs in (
            ("10dot_kernel", "ILb1ELi4Effff"),
            ("10dot_kernel", "ILb0ELi18Eaaff")))
    assert [r["kernel"] for r in _build.kernel_resources(log)] == [
        "dot_kernel<signed,col_tiles=4,f32,f32,f32,f32>",
        "dot_kernel<col_tiles=18,i8,i8,f32,f32>"]


def test_library_path_covers_the_staging_header(tmp_path, monkeypatch):
    """The build hash reads every file of csrc/, so an edit to the shared
    header rebuilds the library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = _build.library_path()
    header = csrc / "staging.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
    assert sorted(p.rsplit("/", 1)[1] for p in _build.sources()) == [
        "battery_dispatch.cu", "bucket_sums.cu", "bucket_sums_dot.cu",
        "bucket_sums_stream.cu", "microbench_dot.cu", "microbench_mask.cu",
        "microbench_mnet.cu", "microbench_pre.cu"]


def test_kernel_resources_name_the_redesigned_kernels():
    pre = "_ZN47_GLOBAL__N__18745352_21_bucket_sums_stream_cu_0011a3e5"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{pre}{name}{targs}EEvPKT2_' "
        "for 'sm_90a'" for name, targs in (
            ("13stream_kernel", "ILb1ELi1ELb0Effff"),
            ("13stream_kernel", "ILb0ELi2ELb1Eaaff"),
            ("17month_pair_kernel", "ILi2ELb1E13__nv_bfloat16S1_S1_S1_")))
    assert [r["kernel"] for r in _build.kernel_resources(log)] == [
        "stream_kernel<signed,spt=1,f32,f32,f32,f32>",
        "stream_kernel<spt=2,drop_zeros,i8,i8,f32,f32>",
        "month_pair_kernel<spt=2,drop_zeros,bf16,bf16,bf16,bf16>"]


def test_kernel_resources_name_the_micro_tensor_core_kernels():
    """The variant kernel's width (its 16-column tiles; 0 without a
    product) and the monthdot kernel's n8 tiles print by name (names from
    an nvcc 12 build log)."""
    pre = "_ZN50_GLOBAL__N__c8cfa117_17_microbench_dot_cu_e48ca6f7"
    tail = "EEvPKfS2_S2_PKiS2_S2_PfS5_iiiiii"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{pre}{name}{targs}{tail}' "
        "for 'sm_90a'" for name, targs in (
            ("14variant_kernel", "ILi0ELi0ELi0ELi8E"),
            ("14variant_kernel", "ILi2ELi1ELi1ELi0E"),
            ("15monthdot_kernel", "ILi2E")))
    assert [r["kernel"] for r in _build.kernel_resources(log)] == [
        "variant_kernel<build=onehot,dot=dot,net=fma,col_tiles=8>",
        "variant_kernel<build=hbm,dot=none,net=bcast,col_tiles=0>",
        "monthdot_kernel<col_tiles=2>"]


def test_kernel_resources_name_the_redesigned_micro_mask_kernels():
    """The grouped month-mask kernel's periods and scales a thread, the
    rank-1-net kernel's n8 tiles and precision, and the prebuilt-mask
    kernel's n8 tiles print by name."""
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__c8cfa117_"
        f"{name}{targs}EEvPKfS2_S2_' for 'sm_90a'" for name, targs in (
            ("18monthmask_g_kernel", "ILi2ELi8E"),
            ("18monthmask_g_kernel", "ILi10ELi4E"),
            ("11mnet_kernel", "ILi1ELb0E"),
            ("11mnet_kernel", "ILi2ELb1E"),
            ("19mask_product_kernel", "ILi1E")))
    assert [r["kernel"] for r in _build.kernel_resources(log)] == [
        "monthmask_g_kernel<periods=2,spt=8>", "monthmask_g_kernel<periods=10,spt=4>",
        "mnet_kernel<col_tiles=1>", "mnet_kernel<col_tiles=2,hi>",
        "mask_product_kernel<col_tiles=1>"]
