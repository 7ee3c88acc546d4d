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


@pytest.mark.parametrize("name", tool.NOT_PORTED)
def test_tool_refuses_variants_that_are_not_ported(name, capsys):
    with pytest.raises(ValueError, match="not ported"):
        tool.run(8, [name], device="cpu")
    assert tool.main(["8", name, "--device", "cpu"]) == 2
    assert name in capsys.readouterr().err


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
        "compact(daylight seg+night sums)", "stream(full-hour dbuf)",
        "stream_compact(uniform dbuf)", "library month engine"]
    assert all(v["ms"] > 0 for v in out["variants"].values())
    # the plain path is not a launch
    assert not any(bk.LAUNCHES.values())
    for name in tool.NOT_PORTED:
        assert name in lines[0]
    assert not any(" device" in ln for ln in lines if "ms/call" in ln)


def test_default_run_parity_lines_are_within_tolerance(default_run):
    out, lines = default_run
    with_parity = {k: v["parity"] for k, v in out["variants"].items() if v["parity"]}
    assert len(with_parity) == 9
    assert sum(ln.startswith("parity ") for ln in lines) == 9
    for name, par in with_parity.items():
        assert par["agents"] == tool.PARITY_AGENTS
        assert par["bad_agents"] == 0, (name, par)
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
