"""Host-side pieces of the period-partitioned staging kernels
(csrc/staging.cuh, csrc/bucket_sums.cu, csrc/bucket_sums_stream.cu)
that run without a card: the stream and pair wrappers' CPU path, the
build hash over the shared header, and the compiler-log names of the
redesigned kernels."""

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
        "microbench_pre.cu"]


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
