"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a CUDA device every test skips (the
kernels have no CPU form). Run on a machine with a card with
``python -m pytest --noconftest tests/test_torch_kernels.py``.

Tolerance of the month, pair and stream kernels: rtol 1e-4, atol 1e-3 x
the agent's largest |plain| value in that output — the kernel sums each
bucket lane by lane and the plain version by matrix product, two float32
orders over up to 768 (bucket) or 8760 (sell) terms. The dot kernel
multiplies in TF32 (10 mantissa bits): rtol 5e-3 and atol 2.0, the
JAX package's bound for its dot engine (tests/test_billpallas.py), and
the per-agent atol above. The micro-benchmark's variants
(ops/microkernels.py) follow their kind: the mask kernels as the month
kernel, the two tensor-core kernels as the dot kernel."""

import numpy as np
import pytest
import torch

from dgen_tpu_torch.io import synth
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import layout
from dgen_tpu_torch.ops import microkernels as mk

pytestmark = pytest.mark.gpu

PERIODS = [1, 2, 3, 4, 10]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _offsets(lanes: str) -> tuple:
    """Month offsets of a lane layout: full-hour, or the synthetic bank's
    daylight-compacted layout (uneven months) or its uniform form."""
    if lanes == "full":
        return layout.FULL_OFFSETS
    lay = layout.daylight_layout(synth.make_solar_cf_profiles(8, seed=1))
    return (lay if lanes == "compacted" else lay.uniform()).offsets


def _inputs(dev, n, r, p, seed=0, offsets=layout.FULL_OFFSETS):
    g = torch.Generator().manual_seed(seed)
    n_lanes = offsets[-1]

    def rand(scale, rows=n):
        return torch.rand((rows, n_lanes), generator=g) * scale

    out = dict(load=rand(3.0), gen=rand(0.9), sell=rand(0.1),
               period=torch.randint(0, p, (n, n_lanes), generator=g, dtype=torch.int32),
               scales=torch.rand((n, r), generator=g) * 4.0, sell_b=rand(0.1),
               period_b=torch.randint(0, p, (n, n_lanes), generator=g,
                                      dtype=torch.int32))
    if n_lanes == 8760:
        out["bucket"] = bk.hourly_bucket_ids(out["period"], p)
    return {k: v.to(dev) for k, v in out.items()}


def _close(got, ref, rtol=1e-4):
    for gt, rf in zip(got, ref):
        assert gt.shape == rf.shape and gt.dtype == torch.float32
        row_max = rf.abs().flatten(1).amax(1).view(-1, *[1] * (rf.ndim - 1))
        tol = rtol * rf.abs() + 1e-3 * row_max
        assert bool(((gt - rf).abs() <= tol).all()), float((gt - rf).abs().max())


def _lane_args(x, offsets, p, signed):
    return (x["load"], x["gen"], x["sell"], x["period"], x["scales"], offsets, p,
            signed)


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 300])
@pytest.mark.parametrize("signed", [False, True])
def test_month_kernel_matches_plain(cuda, p, r, signed):
    x = _inputs(cuda, 37, r, p)
    args = _lane_args(x, layout.FULL_OFFSETS, p, signed)
    before = dict(bk.LAUNCHES)
    got = bk.month_sums(*args)
    torch.cuda.synchronize()
    key = "month_signed" if signed else "month"
    assert bk.LAUNCHES[key] == before[key] + 1
    _close(got, bk.month_sums_plain(*args))


@pytest.mark.parametrize("p", [1, 2, 4, 10])
def test_pair_kernel_matches_plain(cuda, p):
    x = _inputs(cuda, 29, 300, p, seed=1)
    args = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"],
            x["period_b"], x["scales"], layout.FULL_OFFSETS, p)
    before = bk.LAUNCHES["month_pair"]
    got = bk.month_pair_sums(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["month_pair"] == before + 1
    _close(got, bk.month_pair_sums_plain(*args))


@pytest.mark.parametrize("lanes", ["compacted", "uniform"])
@pytest.mark.parametrize("p", [1, 2, 10])
@pytest.mark.parametrize("signed", [False, True])
def test_month_kernel_on_compacted_lanes(cuda, lanes, p, signed):
    offsets = _offsets(lanes)
    x = _inputs(cuda, 23, 300, p, seed=4, offsets=offsets)
    args = _lane_args(x, offsets, p, signed)
    _close(bk.month_sums(*args), bk.month_sums_plain(*args))


@pytest.mark.parametrize("lanes", ["compacted", "uniform"])
@pytest.mark.parametrize("p", [1, 2, 10])
def test_pair_kernel_on_compacted_lanes(cuda, lanes, p):
    offsets = _offsets(lanes)
    x = _inputs(cuda, 19, 300, p, seed=5, offsets=offsets)
    args = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"],
            x["period_b"], x["scales"], offsets, p)
    _close(bk.month_pair_sums(*args), bk.month_pair_sums_plain(*args))


@pytest.mark.parametrize("lanes", ["full", "uniform", "compacted"])
@pytest.mark.parametrize("p", PERIODS)
@pytest.mark.parametrize("r", [25, 300])
@pytest.mark.parametrize("signed", [False, True])
def test_stream_kernel_matches_plain(cuda, lanes, p, r, signed):
    offsets = _offsets(lanes)
    # 43 agents: the last block of five (R = 25) is partly empty
    x = _inputs(cuda, 43, r, p, seed=6, offsets=offsets)
    args = _lane_args(x, offsets, p, signed)
    key = "stream_signed" if signed else "stream"
    before = bk.LAUNCHES[key]
    got = bk.stream_sums(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    _close(got, bk.month_sums_plain(*args))


@pytest.mark.parametrize("p", PERIODS)
@pytest.mark.parametrize("r", [25, 300])
@pytest.mark.parametrize("signed", [False, True])
def test_dot_kernel_matches_plain(cuda, p, r, signed):
    x = _inputs(cuda, 21, r, p, seed=7)
    args = (x["load"], x["gen"], x["sell"], x["bucket"], x["scales"], p, signed)
    key = "dot_signed" if signed else "dot"
    before = bk.LAUNCHES[key]
    got = bk.dot_sums(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    ref = bk.dot_sums_plain(*args)
    _close(got, ref, rtol=5e-3)
    for g, rf in zip(got, ref):
        torch.testing.assert_close(g, rf, rtol=5e-3, atol=2.0)
    # the same function as the month kernel
    lane = bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, signed))
    _close(got, lane, rtol=5e-3)


def _micro_args(x):
    return x["load"], x["gen"], x["sell"], x["bucket"], x["scales"]


def _micro_check(key, fn, plain, x, kwargs, rtol):
    before = bk.LAUNCHES[key]
    got = fn(*_micro_args(x), **kwargs)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    ref = plain(*_micro_args(x), **kwargs)
    _close(got, ref, rtol=rtol)
    if rtol == 5e-3:
        for g, rf in zip(got, ref):
            torch.testing.assert_close(g, rf, rtol=5e-3, atol=2.0)
    return got


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 250])
def test_monthmask_kernel_matches_plain(cuda, p, r):
    x = _inputs(cuda, 37, r, p, seed=8)
    got = _micro_check("monthmask", mk.sums_monthmask, mk.sums_monthmask_plain, x,
                       dict(n_periods=p), 1e-4)
    # the same function as the month kernel
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)))


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 250])
@pytest.mark.parametrize("g_block", [4, 8])
def test_monthmask_g_kernel_matches_plain(cuda, p, r, g_block):
    x = _inputs(cuda, 40, r, p, seed=9)
    _micro_check("monthmask_g", mk.sums_monthmask_g, mk.sums_monthmask_g_plain, x,
                 dict(n_periods=p, g_block=g_block), 1e-4)


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 250])
def test_monthdot_kernel_matches_plain(cuda, p, r):
    x = _inputs(cuda, 21, r, p, seed=10)
    got = _micro_check("monthdot", mk.sums_monthdot, mk.sums_monthdot_plain, x,
                       dict(n_periods=p), 5e-3)
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)),
           rtol=5e-3)


@pytest.mark.parametrize("p", [1, 2, 3, 10])
@pytest.mark.parametrize("r", [25, 250])
def test_variant_kernel_base_matches_plain(cuda, p, r):
    x = _inputs(cuda, 21, r, p, seed=11)
    got = _micro_check("variant", mk.sums_variant, mk.sums_variant_plain, x,
                       dict(n_periods=p), 5e-3)
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)),
           rtol=5e-3)


@pytest.mark.parametrize("kwargs", [
    dict(build="const"), dict(dot="none"), dict(build="const", dot="none"),
    dict(net="bcast"), dict(b_pad=64), dict(b_pad=64, build="const"),
    dict(build="hbm"), dict(build="hbm", dot="none"), dict(net="bcast", dot="none"),
    dict(h_chunk=8), dict(h_chunk=120), dict(b_pad=32, h_chunk=24),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_variant_kernel_forms_match_plain(cuda, kwargs):
    x = _inputs(cuda, 13, 50, 2, seed=12)
    kwargs = dict(kwargs)
    if kwargs.get("build") == "hbm":
        g = torch.Generator().manual_seed(13)
        kwargs["m_hbm"] = torch.rand((13, 8760, 128), generator=g).to(cuda)
    _micro_check("variant", mk.sums_variant, mk.sums_variant_plain, x, kwargs, 5e-3)


def test_micro_kernels_refuse_what_they_do_not_take(cuda):
    x = _inputs(cuda, 6, 8, 2)
    with pytest.raises(ValueError, match="g_block"):
        mk.sums_monthmask_g(*_micro_args(x), g_block=4)
    with pytest.raises(ValueError, match="b_pad"):
        mk.sums_variant(*_micro_args(x), b_pad=16)
    with pytest.raises(TypeError):
        mk.sums_monthdot(x["load"], x["gen"], x["sell"], x["bucket"].long(),
                         x["scales"])
    with pytest.raises(ValueError, match="contiguous"):
        mk.sums_monthmask(x["load"].t().contiguous().t(), x["gen"],
                          x["sell"], x["bucket"], x["scales"])
    # a chunk whose tiles exceed a block's shared memory
    with pytest.raises(RuntimeError, match="microbench_variant"):
        mk.sums_variant(*_micro_args(x), h_chunk=8760)


def test_stream_kernel_refuses_unaligned_months(cuda):
    offsets = list(layout.FULL_OFFSETS)
    offsets[3] += 2             # a month boundary off the 4-lane grid
    x = _inputs(cuda, 4, 8, 2)
    with pytest.raises(RuntimeError, match="bucket_sums_stream"):
        bk.stream_sums(*_lane_args(x, tuple(offsets), 2, False))
    offsets = list(layout.FULL_OFFSETS)
    offsets[1] = 0              # a 1,416-lane second month
    with pytest.raises(RuntimeError, match="bucket_sums_month"):
        bk.month_sums(*_lane_args(x, tuple(offsets), 2, False))


def test_capture_keeps_the_first_launch_operands(cuda):
    x = _inputs(cuda, 8, 16, 2, seed=3)
    first = _lane_args(x, layout.FULL_OFFSETS, 2, False)
    bk.CAPTURE = {}
    try:
        bk.month_sums(*first)
        bk.month_sums(x["load"], x["gen"], x["sell"], x["period"], x["scales"] * 2,
                      layout.FULL_OFFSETS, 2, False)
        bk.stream_sums(*first)
        captured = bk.CAPTURE
    finally:
        bk.CAPTURE = None
    assert list(captured) == ["month", "stream"]
    assert all(a is b for a, b in zip(captured["month"], first))


@pytest.mark.parametrize("impl", bk.IMPLS)
def test_engines_on_the_card_match_the_cpu(cuda, impl):
    x = _inputs(cuda, 16, 50, 2, seed=2)
    cpu = {k: v.cpu() for k, v in x.items()}
    lay = layout.daylight_layout(synth.make_solar_cf_profiles(8, seed=1))
    night = torch.from_numpy(np.array(lay.night)).to(cuda)
    # generation that is zero off-daylight, as the layout's premise needs
    x["gen_day"] = x["gen"] * (1.0 - night)
    cpu["gen_day"] = x["gen_day"].cpu()
    rtol = 5e-3 if impl == "dot" else 1e-4
    for fn, gen, kw in ((bk.import_sums, "gen_day", dict(layout=lay)),
                        (bk.import_sums, "gen", {}), (bk.bucket_sums, "gen", {})):
        keys = ("load", gen, "sell", "bucket", "scales")
        got = fn(*(x[k] for k in keys), 24, impl=impl, **kw)
        ref = fn(*(cpu[k] for k in keys), 24, impl=impl, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=rtol,
                                       atol=1e-3 * float(r.abs().max()))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = _inputs(cuda, 4, 8, 2)
    with pytest.raises(TypeError):
        bk.import_sums(x["load"].half(), x["gen"], x["sell"], x["bucket"],
                       x["scales"], 24)
    with pytest.raises(TypeError):
        bk.import_sums(x["load"], x["gen"], x["sell"], x["bucket"].long(),
                       x["scales"], 24)
    with pytest.raises(TypeError):
        bk.month_sums(x["load"], x["gen"], x["sell"], x["period"].long(),
                      x["scales"], layout.FULL_OFFSETS, 2, False)
    with pytest.raises(ValueError, match="contiguous"):
        bk.import_sums(x["load"], x["gen"], x["sell"], x["bucket"],
                       x["scales"].t().contiguous().t(), 24)
    with pytest.raises(ValueError, match="on"):
        bk.import_sums(x["load"].cpu(), x["gen"], x["sell"], x["bucket"],
                       x["scales"], 24)
    with pytest.raises(ValueError, match="lanes"):
        bk.stream_sums(*_lane_args(x, _offsets("uniform"), 2, False))
