"""The port's kernel micro-benchmark (``dgen_tpu_torch/tools/kernel_microbench.py``,
``dgen_tpu_torch/ops/microkernels.py``) against the JAX tool
(``tools/kernel_microbench.py``) on the CPU.

The same numpy-seeded arrays go through each JAX function, run in the
Pallas interpreter (``pl.pallas_call`` patched to ``interpret=True``; the
tool's file is loaded with importlib and not touched), and through the
port's plain version. The JAX functions return ``[N, r_pad, b_pad]``;
the port returns ``(out[:, :R, :12P], out[:, :R, b_pad - 1])``.

Tolerance: rtol 1e-5, atol 1e-5 x the agent's largest |JAX| value in
that output: the same float32 terms summed in two orders.

One difference is a padding artefact and is corrected here, not in the
port: the JAX copy pads the hour axis to 8832 lanes, and under
``build="const"`` its constant M covers the 72 pad lanes too, so with
``dot="none"`` every column carries 72 x 0.01 more than over 8760 hours.
"""

import contextlib
import functools
import importlib.util
import io
import os

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu_torch.ops import _build
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import microkernels as mk
from dgen_tpu_torch.tools import kernel_microbench as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, R, H = 4, 10, 8760
H_PAD = 8832


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_microbench", os.path.join(ROOT, "tools", "kernel_microbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the JAX tool runs in the interpreter."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def make_inputs(p: int, seed: int = 0, n: int = N, r: int = R) -> dict:
    rng = np.random.default_rng(seed)
    hod = np.arange(H) % 24
    day = ((hod >= 6) & (hod < 18)).astype(np.float32)
    period = rng.integers(0, p, (n, H)).astype(np.int32)
    month = np.asarray(bk.hour_month("cpu"))
    return dict(
        load=rng.uniform(0.2, 3.0, (n, H)).astype(np.float32),
        gen=(rng.uniform(0.0, 1.0, (n, H)) * day).astype(np.float32),
        sell=rng.uniform(0.02, 0.08, (n, H)).astype(np.float32),
        bucket=(month[None, :] * p + period).astype(np.int32),
        scales=rng.uniform(0.1, 6.0, (n, r)).astype(np.float32),
    )


def both(x: dict):
    keys = ("load", "gen", "sell", "bucket", "scales")
    return ([jnp.asarray(x[k]) for k in keys],
            [torch.from_numpy(x[k]) for k in keys])


def hold(got, jax_out, p: int, b_pad: int = 128, r: int = R, rtol=1e-5,
         atol_frac=1e-5):
    jax_out = np.asarray(jax_out)
    refs = (jax_out[:, :r, :12 * p], jax_out[:, :r, b_pad - 1])
    assert len(got) == 2
    for g, ref in zip(got, refs):
        assert g.dtype == torch.float32 and tuple(g.shape) == ref.shape
        atol = atol_frac * np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
        atol = atol.reshape(-1, *[1] * (ref.ndim - 1))
        err = np.abs(g.numpy() - ref)
        assert np.all(err <= rtol * np.abs(ref) + atol), float(err.max())


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("name", ["monthmask", "monthmask_g4", "monthmask_g2",
                                  "monthdot"])
def test_month_variants_match_the_jax_tool(jtool, interpret, name, p):
    jargs, targs = both(make_inputs(p, seed=p))
    if name == "monthmask":
        ref = jtool.sums_monthmask(*jargs, n_periods=p)
        got = mk.sums_monthmask(*targs, n_periods=p)
    elif name == "monthdot":
        ref = jtool.sums_monthdot(*jargs, n_periods=p)
        got = mk.sums_monthdot(*targs, n_periods=p)
    else:
        g_block = int(name[-1])
        ref = jtool.sums_monthmask_g(*jargs, n_periods=p, g_block=g_block)
        got = mk.sums_monthmask_g(*targs, n_periods=p, g_block=g_block)
    hold(got, ref, p)


VARIANT_CASES = (
    # the tool's seven settings and the device-memory build, at the tool's P
    [(dict(kw), 2) for kw, _ in tool.SUMS_VARIANTS.values()]
    + [(dict(build="hbm"), 2), (dict(build="hbm", dot="none"), 2),
       (dict(h_chunk=120), 2)]
    # the real forms at the other period counts, where b_pad holds 12 P + 1
    + [(dict(), 1), (dict(), 3), (dict(), 10), (dict(b_pad=64), 1),
       (dict(b_pad=64), 3), (dict(build="hbm"), 10), (dict(b_pad=16), 1)]
)


@pytest.mark.parametrize(
    "kwargs,p", VARIANT_CASES,
    ids=["-".join([f"{k}={v}" for k, v in kw.items()] or ["base"]) + f"-P{p}"
         for kw, p in VARIANT_CASES])
def test_variant_forms_match_the_jax_tool(jtool, interpret, kwargs, p):
    x = make_inputs(p, seed=20 + p)
    jargs, targs = both(x)
    b_pad = kwargs.get("b_pad", 128)
    jkw, tkw = dict(kwargs), dict(kwargs)
    jkw.pop("h_chunk", None)     # the JAX chunk is a divisor of its 8832 lanes
    if kwargs.get("build") == "hbm":
        m = np.random.default_rng(7).uniform(0, 1, (N, H, b_pad)).astype(np.float32)
        jkw["m_hbm"] = jnp.asarray(np.pad(m, ((0, 0), (0, H_PAD - H), (0, 0))))
        tkw["m_hbm"] = torch.from_numpy(m)
    ref = np.array(jtool.sums_variant(*jargs, **jkw))
    if kwargs.get("build") == "const" and kwargs.get("dot") == "none":
        ref -= np.float32(mk.CONST_M * (H_PAD - H))
    got = mk.sums_variant(*targs, n_periods=p, **tkw)
    hold(got, ref, p, b_pad=b_pad)


PRE_CASES = [(1, 8), (2, 8), (3, 8), (7, 8), (10, 16)]


def _month_lanes(jtool, x: np.ndarray) -> np.ndarray:
    """The JAX tool's month-padded lanes of [..., 8760] hour values."""
    idx, valid = jtool._month_layout()
    return x[..., idx] * valid


@pytest.mark.parametrize("p,c_pad", PRE_CASES)
def test_mask_cols_match_the_jax_tool(jtool, p, c_pad):
    """The port's M over the 8760 hours is the JAX tool's M over its
    month-padded lanes, lane for lane, with zeros in the pad lanes."""
    x = make_inputs(p, seed=40 + p)
    period = x["bucket"] % p
    idx, valid = jtool._month_layout()
    ref = np.asarray(jtool.build_mask_cols(
        jnp.asarray(x["sell"]), jnp.asarray(period), jnp.asarray(valid),
        jnp.asarray(idx), p, c_pad))
    got = mk.build_mask_cols(torch.from_numpy(x["sell"]), torch.from_numpy(period),
                             p, c_pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, c_pad, H)
    np.testing.assert_array_equal(_month_lanes(jtool, got.numpy()), ref)


@pytest.mark.parametrize("p,c_pad", PRE_CASES)
@pytest.mark.parametrize("name", ["monthdot_pre", "mnet", "mnet_hi"])
def test_prebuilt_mask_variants_match_the_jax_tool(jtool, interpret, name, p, c_pad):
    jargs, targs = both(make_inputs(p, seed=50 + p))
    kw = dict(n_periods=p, c_pad=c_pad)
    if name == "monthdot_pre":
        ref = jtool.sums_monthdot_pre(*jargs, **kw)
        got = mk.sums_monthdot_pre(*targs, **kw)
    else:
        hi = name == "mnet_hi"
        ref = jtool.sums_mnet(*jargs, hi=hi, **kw)
        got = mk.sums_mnet(*targs, hi=hi, **kw)
    hold(got, ref, p)
    # a prebuilt M gives the same sums as one built in the call
    m = mk.build_mask_cols(targs[2], targs[3] % p, p, c_pad)
    again = mk.sums_monthdot_pre(*targs, prebuilt=m, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_mask_cols_refuse_a_c_pad_below_p_plus_one(jtool):
    x = make_inputs(3)
    sell, period = torch.from_numpy(x["sell"]), torch.from_numpy(x["bucket"] % 3)
    # below P + 1, and (3, 12) not a whole number of 8-column tiles
    for p, c_pad in ((8, 8), (3, 2), (3, 12), (10, 8)):
        with pytest.raises(ValueError, match="c_pad"):
            mk.build_mask_cols(sell, period, p, c_pad)
    with pytest.raises(ValueError, match="c_pad"):
        mk.sums_mnet(*both(x)[1], n_periods=8, c_pad=8)
    # the JAX tool's pad refuses it too
    idx, valid = jtool._month_layout()
    with pytest.raises(ValueError):
        jtool.build_mask_cols(jnp.asarray(x["sell"]), jnp.asarray(x["bucket"] % 8),
                              jnp.asarray(valid), jnp.asarray(idx), 8, 8)


def test_quant_variant_is_the_jax_tools_quantization():
    """The tool's int8 codes and scales are the JAX tool's formula, and
    the variant is the month engine on the codes with the scales folded."""
    x = make_inputs(2, seed=60)
    load = x["load"]
    codes, scale = tool.quantize(torch.from_numpy(load))
    ls = np.maximum(np.max(np.abs(load), axis=1), 1e-9).astype(np.float32) / 127.0
    want = np.clip(np.round(load / ls[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(
        jnp.maximum(jnp.max(jnp.abs(jnp.asarray(load)), axis=1), 1e-9) / 127.0))
    np.testing.assert_array_equal(codes.numpy(), want)


def test_ablated_forms_are_what_the_kernel_body_says():
    """``dot="none"`` puts one sum per scale into every column, ``const``
    scales the row sums by 0.01, ``bcast`` drops the scales."""
    _, targs = both(make_inputs(2, seed=5))
    load, gen = targs[0], targs[1]
    pos_sum = torch.clamp_min(load[:, None, :] - targs[4][:, :, None] * gen[:, None, :],
                              0.0).double().sum(2)
    imp, sell = mk.sums_variant(*targs, build="const", dot="none")
    want = pos_sum + mk.CONST_M * H
    torch.testing.assert_close(sell.double(), want, rtol=1e-5, atol=0)
    assert torch.equal(imp, sell[:, :, None].expand_as(imp))
    imp, sell = mk.sums_variant(*targs, build="const")
    torch.testing.assert_close(sell.double(), mk.CONST_M * pos_sum, rtol=1e-5, atol=0)
    imp, sell = mk.sums_variant(*targs, net="bcast")
    assert torch.equal(imp[:, 0], imp[:, -1])
    torch.testing.assert_close(imp.double().sum(2)[:, 0], load.double().sum(1),
                               rtol=1e-5, atol=0)


def test_piecewise_matches_the_jax_tool(jtool):
    for p in (1, 2, 3):
        jargs, targs = both(make_inputs(p, seed=30 + p))
        ref = jtool.sums_piecewise(*jargs, n_periods=p)
        got = tool.sums_piecewise(*targs, n_periods=p)
        # differences of suffix sums: float32 cancellation on top of the order
        hold(got, ref, p, rtol=1e-4, atol_frac=1e-5)
        # and it is the month engine's function
        lib = bk.import_sums(*targs, 12 * p)
        for g, rf in zip(got, lib):
            assert tool.bad_agents(g, rf, 1e-4) == 0


@pytest.mark.parametrize("call,exc,match", [
    (lambda a: mk.sums_monthmask_g(*a, g_block=3), ValueError, "g_block"),
    (lambda a: mk.sums_variant(*a, b_pad=16), ValueError, "b_pad"),
    (lambda a: mk.sums_variant(*a, b_pad=40), ValueError, "b_pad"),
    (lambda a: mk.sums_variant(*a, b_pad=256), ValueError, "b_pad"),
    (lambda a: mk.sums_variant(*a, n_periods=10, b_pad=64), ValueError, "b_pad"),
    (lambda a: mk.sums_variant(*a, build="vmem"), ValueError, "build"),
    (lambda a: mk.sums_variant(*a, build="hbm"), ValueError, "m_hbm"),
    (lambda a: mk.sums_variant(*a, m_hbm=torch.zeros(N, H, 128)), ValueError,
     "m_hbm"),
    (lambda a: mk.sums_variant(*a, build="hbm", m_hbm=torch.zeros(N, H, 64)),
     ValueError, "m_hbm"),
    (lambda a: mk.sums_variant(*a, h_chunk=100), ValueError, "h_chunk"),
    (lambda a: mk.sums_monthdot(*a, n_periods=11), ValueError, "n_periods"),
    (lambda a: mk.sums_monthmask(a[0], a[1], a[2], a[3].long(), a[4]), TypeError,
     "int32"),
    (lambda a: mk.sums_variant(a[0], a[1], a[2], a[3].long(), a[4]), TypeError,
     "int32"),
], ids=["ragged-g_block", "b_pad-too-small", "b_pad-not-16s", "b_pad-too-wide",
        "b_pad-64-at-P10", "unknown-build", "hbm-without-m", "m-without-hbm",
        "m-wrong-width", "h_chunk-not-a-divisor", "eleven-periods",
        "int64-ids-mask", "int64-ids-variant"])
def test_refusals(call, exc, match):
    _, targs = both(make_inputs(2))
    with pytest.raises(exc, match=match):
        call(targs)


@pytest.mark.parametrize("name", ["monthdot_pre", "mnet", "mnet_hi", "quant"])
def test_tool_refuses_variants_that_are_not_ported(name, capsys):
    """The four variants that waited for their kernels now run under
    their names; a name next to one of them is still refused."""
    out = tool.run(8, [name], device="cpu", reps=1)
    (got,) = out["variants"].values()
    assert got["parity"]["bad_agents"] == 0
    with pytest.raises(ValueError, match="no variant is named"):
        tool.run(8, [name + "x"], device="cpu")
    assert tool.main(["8", name + "x", "--device", "cpu"]) == 2
    assert name + "x" in capsys.readouterr().err


def test_tool_refuses_unknown_names_and_a_missing_card():
    with pytest.raises(ValueError, match="no variant is named"):
        tool.run(8, ["monthmasc"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.run(8)


@pytest.fixture(scope="module")
def default_run():
    """(result, printed lines) of the tool's default run at 64 agents."""
    bk.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tool.run(64, device="cpu", reps=1)
    return out, buf.getvalue().splitlines()


def test_default_run_on_the_cpu_runs_every_variant(default_run):
    out, lines = default_run
    assert out["device"] == "cpu" and out["timed_on"] == "cpu"
    assert list(out["variants"]) == [
        *tool.SUMS_VARIANTS, "monthmask(no onehot,no MXU)", "monthmask_g4",
        "monthmask_g8", "monthdot(positional M,dot)",
        "monthdot_pre(prebuilt M,MXU)", "mnet(rank-1 MXU net)",
        "mnet_hi(rank-1 MXU net/hi)", "compact(daylight seg+night sums)",
        "stream(full-hour dbuf)", "stream_compact(uniform dbuf)",
        "quant(int8 streams)", "library month engine"]
    assert all(v["ms"] > 0 for v in out["variants"].values())
    # the plain path is not a launch
    assert not any(bk.LAUNCHES.values())
    assert "every variant but piecewise" in lines[0]
    assert any(ln.startswith("mask columns M [64, 8, 8760]") for ln in lines)
    assert any(ln.startswith("quant: int8 load/gen codes") for ln in lines)
    assert not any(" device" in ln for ln in lines if "ms/call" in ln)


def test_default_run_parity_lines_are_within_tolerance(default_run):
    out, lines = default_run
    with_parity = {k: v["parity"] for k, v in out["variants"].items() if v["parity"]}
    assert len(with_parity) == 13
    assert sum(ln.startswith("parity ") for ln in lines) == 13
    for name, par in with_parity.items():
        assert par["agents"] == tool.PARITY_AGENTS
        assert par["bad_agents"] == 0, (name, par)
        if par["kind"] == "int8":
            # the codes' rounding, far inside the 2% envelope
            assert par["rel_buckets"] < 2e-3, (name, par)
        else:
            # plain versions in float32: far inside the card's tolerance
            assert par["rel_buckets"] < 1e-5, (name, par)
    ablated = [k for k, (_, real) in tool.SUMS_VARIANTS.items() if not real]
    assert all(out["variants"][k]["parity"] is None for k in ablated)


def test_named_run_selects_by_substring_and_exact_name(capsys):
    out = tool.run(32, ["const", "mg4", "piecewise"], device="cpu", reps=1)
    assert list(out["variants"]) == [
        "const_m(no onehot build)", "no_dot_const(no build,no MXU)", "b64_const",
        "monthmask_g4", "piecewise(sorted-hinge,plain)"]
    assert out["variants"]["piecewise(sorted-hinge,plain)"]["parity"]["bad_agents"] == 0
    assert "not ported" not in capsys.readouterr().out


def test_make_data_is_seeded_and_diurnal():
    a = tool.make_data(6, torch.device("cpu"), seed=3)
    b = tool.make_data(6, torch.device("cpu"), seed=3)
    c = tool.make_data(6, torch.device("cpu"), seed=4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    load, gen, sell, bucket, scales = a
    assert bucket.dtype == torch.int32 and scales.shape == (6, tool.N_SCALES)
    night = torch.from_numpy(tool.day_mask()) == 0
    assert bool((gen[:, night] == 0).all()) and bool((gen[:, ~night] > 0).any())
    assert 0.2 <= float(load.min()) and float(load.max()) <= 3.0
    assert int(bucket.max()) == 12 * tool.N_PERIODS - 1 and int(bucket.min()) == 0


def test_kernel_resources_names_any_template_arguments():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__7c1a_19_"
        "microbench_dot_cu_a14variant_kernelILi2ELi0ELi1EEEvPKfS2_' for 'sm_90a'",
        "ptxas info    : Used 96 registers, 0 bytes smem",
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__7c1a_14_"
        "bucket_sums_cu_a12month_kernelILb1EEEvPKfS2_' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 43 registers, 12288 bytes smem, 512 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__7c1a_14_"
        "bucket_sums_cu_a12month_kernelILb0EEEvPKfS2_' for 'sm_90a'",
        "ptxas info    : Used 32 registers, 12288 bytes smem",
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__7c1a_20_"
        "microbench_mask_cu_a18monthmask_g_kernelEPKfS1_' for 'sm_90a'",
        "ptxas info    : Used 32 registers",
    ])
    rows = _build.kernel_resources(log)
    assert [r["kernel"] for r in rows] == [
        "variant_kernel<build=hbm,dot=dot,net=bcast>", "month_kernel<signed>",
        "month_kernel", "monthmask_g_kernel"]
    assert [r["registers"] for r in rows] == [96, 43, 32, 32]
    assert [r["spill_bytes"] for r in rows] == [0, 12, 0, 0]
    assert [r["smem_bytes"] for r in rows] == [0, 12288, 12288, 0]
    for name in ("microbench_monthmask", "microbench_monthmask_g",
                 "microbench_monthdot", "microbench_variant"):
        assert name in _build._SIGNATURES


def test_kernel_resources_names_the_stream_types():
    """Type template arguments print as dtypes (load, gen, sell, sums); a
    repeated bfloat16 is a substitution of the first (names from an nvcc
    12.8 build log)."""
    pre = "_ZN47_GLOBAL__N__18745352_14_bucket_sums_cu_0011a3e512month_kernel"
    tail = "EEvPKT0_PKT1_PKT2_PKiPKfPT3_SG_SG_SG_iiiiN5lanes12MonthOffsetsE"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{pre}{targs}{tail}' for 'sm_90a'"
        for targs in ("ILb0Eaa13__nv_bfloat16S1_", "ILb0Eaaff",
                      "ILb1E13__nv_bfloat16fS1_f", "ILb1E13__nv_bfloat16S1_S1_S1_"))
    assert [r["kernel"] for r in _build.kernel_resources(log)] == [
        "month_kernel<i8,i8,bf16,bf16>", "month_kernel<i8,i8,f32,f32>",
        "month_kernel<signed,bf16,f32,bf16,f32>",
        "month_kernel<signed,bf16,bf16,bf16,bf16>"]
    for name in ("microbench_monthdot_pre", "microbench_mnet"):
        assert name in _build._SIGNATURES


def test_ab_ms_alternates_and_counts_wins():
    calls = []

    def slow():
        sum(range(200_000))
        calls.append("b")

    ms_a, ms_b, wins = tool.ab_ms(lambda: calls.append("a"), slow, pairs=4,
                                  device=torch.device("cpu"))
    assert ms_a < ms_b and wins == 4, (ms_a, ms_b, wins)
    # each timing is a warm-up and 5 calls; the second pair starts with b
    assert calls[:12] == ["a"] * 6 + ["b"] * 6
    assert calls[12:18] == ["b"] * 6


def test_parent_ab_cuts_agent_rows_and_flattens_outputs():
    from dgen_tpu_torch.ops import dispatch
    from dgen_tpu_torch.tools import kernel_parent_ab as ab

    load, scales = torch.zeros((6, 16)), torch.zeros((6, 3))
    cut = ab.first_rows((load, scales, torch.zeros(6), (0, 16), 2, True), 2)
    assert [tuple(t.shape) for t in cut[:3]] == [(2, 16), (2, 3), (2,)]
    assert cut[3:] == ((0, 16), 2, True) and cut[0].is_contiguous()
    res = dispatch.DispatchResult(*(torch.full((1,), float(i)) for i in range(4)))
    assert [float(t) for t in ab.outputs(res)] == [0.0, 1.0, 2.0, 3.0]
    assert ab.outputs([load]) == (load,)


def test_parent_ab_takes_the_micro_benchmark_kernels():
    """kernel_parent_ab's micro-benchmark keys: the launch-count keys of
    the six kernels (mnet twice), each on the tool's own seeded data (the
    prebuilt-mask kernels on M in place of sell and the bucket ids), each
    wrapper in the tool's default setting; on the CPU a wrapper is its
    plain version and counts no launch."""
    from dgen_tpu_torch.tools import kernel_parent_ab as ab

    assert set(ab.MICRO_KERNELS) == {"variant", "monthdot", "monthmask",
                                     "monthmask_g", "monthdot_pre", "mnet",
                                     "mnet_hi"}
    assert set(ab.MICRO_KERNELS) <= set(ab.KERNELS) & set(bk.LAUNCHES)
    cpu = torch.device("cpu")
    data = tool.make_data(8, cpu, seed=3)
    for got, want in zip(ab.micro_operands("variant", 8, seed=3, device=cpu), data):
        assert torch.equal(got, want)
    load, gen, m, scales = ab.micro_operands("mnet_hi", 8, seed=3, device=cpu)
    assert torch.equal(m, mk.build_mask_cols(data[2], data[3] % tool.N_PERIODS,
                                             tool.N_PERIODS, tool.C_PAD))
    before = dict(bk.LAUNCHES)
    for key, (wrapper, plain) in ab.MICRO_KERNELS.items():
        args = ab.first_rows(ab.micro_operands(key, 8, seed=3, device=cpu), 8)
        got, ref = wrapper(*args), plain(*args)
        assert [tuple(t.shape) for t in got] == [(8, tool.N_SCALES,
                                                  12 * tool.N_PERIODS),
                                                 (8, tool.N_SCALES)], key
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), key
    assert bk.LAUNCHES == before
    cut = ab.first_rows(ab.micro_operands("monthdot_pre", 8, device=cpu), 2)
    assert [tuple(t.shape) for t in cut] == [(2, 8760), (2, 8760),
                                             (2, tool.C_PAD, 8760),
                                             (2, tool.N_SCALES)]
