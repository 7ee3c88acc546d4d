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
kernel, the two tensor-core kernels as the dot kernel. The battery
dispatch kernel (ops/dispatch.py) rounds every operation as its plain
loop does and is held to it bit for bit (torch.equal; NaN in the same
places where a load is NaN); so are the month
kernel's per-period sums, on inputs where net = load exactly, to a
lane-by-lane float32 sum."""

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


#: (kind, (load, gen, sell) dtypes): every stream combination the engine
#: kernels are instantiated for
DOT_CASES = ([("import", d) for d in bk.IMPORT_DTYPES]
             + [("signed", d) for d in bk.SIGNED_DTYPES])


def _case_id(case):
    kind, dtypes = case
    return kind + "-" + "-".join(str(t).replace("torch.", "") for t in dtypes)


@pytest.mark.parametrize("case", DOT_CASES, ids=_case_id)
@pytest.mark.parametrize("p", [1, 2, 3, 5, 10])
@pytest.mark.parametrize("r", [1, 16, 17, 25, 33, 300, 700])
def test_dot_kernel_matches_plain(cuda, case, p, r):
    """The dot kernel against its plain version and the month kernel's,
    at the dot engine's tolerance: P = 1, 2, 3, 5 and 10 run each of its
    column-tile forms (2, 4, 8, 12 and 18 tiles), R = 17 and 33 leave a
    row tile partly empty, R = 700 takes two blocks an agent (the second
    partly empty), and the last day of December sits in the last period,
    the last live bucket column before the sell column."""
    kind, dtypes = case
    signed = kind == "signed"
    x = _inputs(cuda, 21, r, p, seed=7)
    x["period"][:, -24:] = p - 1
    x["bucket"] = bk.hourly_bucket_ids(x["period"], p)
    x = _narrow(x, dtypes)
    args = (x["load"], x["gen"], x["sell"], x["bucket"], x["scales"], p, signed)
    key = "dot_signed" if signed else "dot"
    before = bk.LAUNCHES[key]
    got = bk.dot_sums(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    out_dtype = bk._sums_out_dtype(*dtypes)
    extra = BF16_ULP if out_dtype == torch.bfloat16 else 0.0
    # the same function as the month kernel
    lane = bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, signed))
    for ref in (bk.dot_sums_plain(*args), lane):
        _close_at(got, ref, out_dtype, rtol=5e-3)
        for g, rf in zip(got, ref):
            torch.testing.assert_close(g.float(), rf.float(), rtol=5e-3 + extra,
                                       atol=2.0)


@pytest.mark.parametrize("case", DOT_CASES, ids=_case_id)
def test_dot_kernel_takes_rows_from_any_agent(cuda, case):
    """The streams of agents 3.. of an array are a view that starts one
    row in (8,760 bytes for int8 codes, so 8-byte but not 16-byte aligned):
    the kernel takes it and matches its plain version; a stream that
    starts one element off its copy size is refused."""
    kind, dtypes = case
    signed = kind == "signed"
    x = _narrow(_inputs(cuda, 8, 25, 2, seed=11), dtypes)
    args = [x["load"][3:], x["gen"][3:], x["sell"][3:], x["bucket"][3:],
            x["scales"][3:], 2, signed]
    assert all(t.is_contiguous() for t in args[:5])
    got = bk.dot_sums(*args)
    extra = BF16_ULP if bk._sums_out_dtype(*dtypes) == torch.bfloat16 else 0.0
    for g, rf in zip(got, bk.dot_sums_plain(*args)):
        torch.testing.assert_close(g.float(), rf.float(), rtol=5e-3 + extra,
                                   atol=2.0)
    load = x["load"].flatten()[1:1 + 5 * 8760].view(5, 8760)
    with pytest.raises(RuntimeError, match="alignment"):
        bk.dot_sums(load, *args[1:])


def test_dot_kernel_rounds_operands_to_nearest_tf32(cuda):
    """The import products take relu(net) and the sell rate rounded to the
    nearest TF32 value (10 mantissa bits, ties away from zero), the one-hot
    ones exactly, so one hour's import sums are the rounded values:
    1 + 2^-11 + 2^-13 and the tie 1 + 2^-11 give 1 + 2^-10, a sell rate
    of 1 + 2^-11 + 2^-13 times a load of 1 gives 1 + 2^-10. The signed
    products take net and the sell rate as two TF32 parts each (3xTF32),
    which carry these values exactly."""
    above, tie, up = 1 + 2.0 ** -11 + 2.0 ** -13, 1 + 2.0 ** -11, 1 + 2.0 ** -10
    load = torch.zeros((4, 8760))
    sell = torch.zeros((4, 8760))
    load[:, 0] = torch.tensor([above, tie, -tie, 1.0])
    sell[3, 0] = above
    zeros = torch.zeros((4, 8760), dtype=torch.int32)
    scales = torch.zeros((4, 1))
    got = bk.dot_sums(*(t.to(cuda) for t in (load, torch.zeros((4, 8760)), sell,
                                             bk.hourly_bucket_ids(zeros, 1),
                                             scales)), 1, True)
    want_imp = torch.zeros((4, 1, 12))
    want_imp[:, 0, 0] = torch.tensor([up, up, 0.0, 1.0])
    want_sgn = torch.zeros((4, 1, 12))
    want_sgn[:, 0, 0] = torch.tensor([above, tie, -tie, 1.0])
    want_imp_sell = torch.tensor([[0.0], [0.0], [0.0], [up]])
    want_sgn_sell = torch.tensor([[0.0], [0.0], [0.0], [above]])
    for g, w in zip(got, (want_imp, want_imp_sell, want_sgn, want_sgn_sell)):
        assert torch.equal(g.cpu(), w), (g.cpu(), w)


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


#: scale counts of the micro-benchmark's tensor-core kernels: one row, a
#: ragged row tile, one warpgroup, the tool's 250, and 300 (two blocks)
MICRO_R = [1, 17, 25, 64, 250, 300]


@pytest.mark.parametrize("p", PERIODS)
@pytest.mark.parametrize("r", MICRO_R)
def test_monthdot_kernel_matches_plain(cuda, p, r):
    x = _inputs(cuda, 21, r, p, seed=10)
    got = _micro_check("monthdot", mk.sums_monthdot, mk.sums_monthdot_plain, x,
                       dict(n_periods=p), 5e-3)
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)),
           rtol=5e-3)


@pytest.mark.parametrize("p", PERIODS)
@pytest.mark.parametrize("r", MICRO_R)
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


#: (P, b_pad, h_chunk) of the every-form grid: three chunk depths at 64
#: columns, and every width one period leaves room for (so every
#: instantiation of the kernel runs)
VARIANT_FORM_SHAPES = [(3, 64, h) for h in (8, 40, 120)] + [
    (1, b, 40) for b in range(16, mk.MAX_B_PAD + 1, 16) if b != 64]


@pytest.mark.parametrize("p,b_pad,h_chunk", VARIANT_FORM_SHAPES)
@pytest.mark.parametrize("net", mk.NETS)
@pytest.mark.parametrize("dot", mk.DOTS)
@pytest.mark.parametrize("build", mk.BUILDS)
def test_variant_kernel_every_form_matches_plain(cuda, build, dot, net, p, b_pad,
                                                 h_chunk):
    """Every build x dot x net form at three chunk depths and at every
    width, on two warpgroups (70 scales); the forms without a product at
    the month kernel's tolerance."""
    x = _inputs(cuda, 5, 70, p, seed=14)
    kwargs = dict(n_periods=p, b_pad=b_pad, build=build, dot=dot, net=net,
                  h_chunk=h_chunk)
    if build == "hbm":
        g = torch.Generator().manual_seed(15)
        kwargs["m_hbm"] = torch.rand((5, 8760, b_pad), generator=g).to(cuda)
    _micro_check("variant", mk.sums_variant, mk.sums_variant_plain, x, kwargs,
                 1e-4 if dot == "none" else 5e-3)


@pytest.mark.parametrize("p,b_pad", [
    (p, b) for p in PERIODS for b in range(16, mk.MAX_B_PAD + 1, 16)
    if b >= 12 * p + 1])
def test_variant_kernel_widths_match_plain(cuda, p, b_pad):
    """Every width a tariff's periods leave room for: one product of 16,
    32, 64 or 128 columns a k-step, or its binary parts."""
    x = _inputs(cuda, 3, 17, p, seed=16)
    got = _micro_check("variant", mk.sums_variant, mk.sums_variant_plain, x,
                       dict(n_periods=p, b_pad=b_pad), 5e-3)
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)),
           rtol=5e-3)


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


# ---------------------------------------------------------------------------
# The prebuilt-mask kernels (microbench_pre.cu)
# ---------------------------------------------------------------------------

PRE_CASES = [(1, 8), (2, 8), (3, 8), (7, 8), (10, 16), (2, 16)]


@pytest.mark.parametrize("p,c_pad", PRE_CASES)
@pytest.mark.parametrize("r", [25, 250])
def test_monthdot_pre_kernel_matches_plain(cuda, p, c_pad, r):
    x = _inputs(cuda, 21, r, p, seed=14)
    m = mk.build_mask_cols(x["sell"], x["period"], p, c_pad)
    before = bk.LAUNCHES["monthdot_pre"]
    got = mk.monthdot_pre_sums(x["load"], x["gen"], m, x["scales"], n_periods=p)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["monthdot_pre"] == before + 1
    ref = mk.mask_product_plain(x["load"], x["gen"], m, x["scales"], n_periods=p)
    _close(got, ref, rtol=5e-3)
    for g, rf in zip(got, ref):
        torch.testing.assert_close(g, rf, rtol=5e-3, atol=2.0)
    # the month kernel's function
    _close(got, bk.month_sums_plain(*_lane_args(x, layout.FULL_OFFSETS, p, False)),
           rtol=5e-3)


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("p,c_pad", PRE_CASES)
@pytest.mark.parametrize("r", [25, 250])
def test_mnet_kernel_matches_plain(cuda, hi, p, c_pad, r):
    """TF32 at the tensor-core tolerance; 3xTF32 (hi) at the month
    kernel's float32 one."""
    x = _inputs(cuda, 21, r, p, seed=15)
    m = mk.build_mask_cols(x["sell"], x["period"], p, c_pad)
    key = "mnet_hi" if hi else "mnet"
    before = bk.LAUNCHES[key]
    got = mk.sums_mnet(x["load"], x["gen"], x["sell"], x["bucket"], x["scales"],
                       n_periods=p, c_pad=c_pad, hi=hi, prebuilt=m)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    ref = mk.mask_product_plain(x["load"], x["gen"], m, x["scales"], n_periods=p)
    if hi:
        _close(got, ref)
    else:
        _close(got, ref, rtol=5e-3)
        for g, rf in zip(got, ref):
            torch.testing.assert_close(g, rf, rtol=5e-3, atol=2.0)


def test_mask_kernels_refuse_what_they_do_not_take(cuda):
    x = _inputs(cuda, 6, 8, 2)
    m = mk.build_mask_cols(x["sell"], x["period"], 2, 8)
    with pytest.raises(ValueError, match="c_pad"):
        mk.sums_monthdot_pre(*_micro_args(x), c_pad=12)
    with pytest.raises(ValueError, match="c_pad"):
        mk.sums_mnet(*_micro_args(x), n_periods=8, c_pad=8)
    with pytest.raises(ValueError, match="M must be"):
        mk.monthdot_pre_sums(x["load"], x["gen"], m[:, :, :8000].contiguous(),
                             x["scales"], n_periods=2)
    with pytest.raises(TypeError):
        mk.mnet_sums(x["load"].bfloat16(), x["gen"], m, x["scales"])


# ---------------------------------------------------------------------------
# bf16 and int8 streams through the engine kernels
# ---------------------------------------------------------------------------

#: one bfloat16 unit in the last place (2^-7 of the value) on top of the
#: float32 tolerance: kernel and plain version round the same float32
#: sum, taken in two orders, to bfloat16 and may land on neighbours
BF16_ULP = 2.0 ** -7


def _narrow(x, dtypes):
    """The float streams of ``x`` at (load, gen, sell) ``dtypes``; int8
    load and gen become codes of their values (0..127 here)."""
    out = dict(x)
    for key, dt in zip(("load", "gen", "sell"), dtypes):
        if dt == torch.int8:
            t = x[key]
            out[key] = torch.round(t / t.amax() * 127).to(torch.int8)
        else:
            out[key] = x[key].to(dt)
    if dtypes[2] != torch.float32:
        out["sell_b"] = x["sell_b"].to(dtypes[2])
    return out


def _close_at(got, ref, out_dtype, rtol=1e-4):
    for gt, rf in zip(got, ref):
        assert gt.dtype == rf.dtype == out_dtype
    extra = BF16_ULP if out_dtype == torch.bfloat16 else 0.0
    for gt, rf in zip(got, ref):
        gt, rf = gt.float(), rf.float()
        row_max = rf.abs().flatten(1).amax(1).view(-1, *[1] * (rf.ndim - 1))
        tol = (rtol + extra) * rf.abs() + 1e-3 * row_max
        assert bool(((gt - rf).abs() <= tol).all()), float((gt - rf).abs().max())


NARROW = ([("import", d) for d in bk.IMPORT_DTYPES[1:]]
          + [("signed", d) for d in bk.SIGNED_DTYPES[1:]])


def _ids(case):
    kind, d = case
    return kind + "-" + "-".join(str(t).replace("torch.", "") for t in d)


@pytest.mark.parametrize("case", NARROW, ids=_ids)
@pytest.mark.parametrize("engine", ["month", "stream", "dot"])
@pytest.mark.parametrize("p", [1, 2, 10])
def test_engine_kernels_take_narrow_streams(cuda, case, engine, p):
    kind, dtypes = case
    signed = kind == "signed"
    x = _narrow(_inputs(cuda, 29, 60, p, seed=16), dtypes)
    out_dtype = bk._sums_out_dtype(*dtypes)
    if engine == "dot":
        args = (x["load"], x["gen"], x["sell"], x["bucket"], x["scales"], p, signed)
        fn, plain, rtol = bk.dot_sums, bk.dot_sums_plain, 5e-3
    else:
        args = _lane_args(x, layout.FULL_OFFSETS, p, signed)
        fn = bk.month_sums if engine == "month" else bk.stream_sums
        plain, rtol = bk.month_sums_plain, 1e-4
    key = engine + ("_signed" if signed else "")
    before = bk.LAUNCHES[key]
    got = fn(*args)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    _close_at(got, plain(*args), out_dtype, rtol)


@pytest.mark.parametrize("dtypes", bk.IMPORT_DTYPES[1:], ids=lambda d: "-".join(
    str(t).replace("torch.", "") for t in d))
@pytest.mark.parametrize("lanes", ["full", "uniform"])
def test_narrow_streams_on_compacted_lanes(cuda, dtypes, lanes):
    """The pair kernel, and the stream kernel on uniform compacted lanes,
    with narrow streams."""
    offsets = _offsets(lanes)
    x = _narrow(_inputs(cuda, 19, 60, 2, seed=17, offsets=offsets), dtypes)
    out_dtype = bk._sums_out_dtype(*dtypes)
    args = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"],
            x["period_b"], x["scales"], offsets, 2)
    _close_at(bk.month_pair_sums(*args), bk.month_pair_sums_plain(*args), out_dtype)
    args = _lane_args(x, offsets, 2, False)
    _close_at(bk.stream_sums(*args), bk.month_sums_plain(*args), out_dtype)


def test_quantized_import_sums_on_the_card_match_the_cpu(cuda):
    """int8 codes with their scales folded through import_sums and the
    pair entry, card vs CPU (the fold and unfold are plain tensor code)."""
    x = _inputs(cuda, 16, 50, 2, seed=18)
    lq = torch.round(x["load"] / 3.0 * 127).to(torch.int8)
    gq = torch.round(x["gen"] / 0.9 * 127).to(torch.int8)
    ls = torch.full((16,), 3.0 / 127, device=cuda)
    gs = torch.full((16,), 0.9 / 127, device=cuda)
    for impl in bk.IMPLS:
        for sell in (x["sell"], x["sell"].bfloat16()):
            args = (lq, gq, sell, x["bucket"], x["scales"], 24)
            got = bk.import_sums(*args, impl=impl, load_scale=ls, gen_scale=gs)
            ref = bk.import_sums(*(a.cpu() if torch.is_tensor(a) else a
                                   for a in args), impl=impl,
                                 load_scale=ls.cpu(), gen_scale=gs.cpu())
            _close_at([g.cpu() for g in got], ref, bk._sums_out_dtype(
                torch.int8, torch.int8, sell.dtype), 5e-3 if impl == "dot" else 1e-4)


def test_engines_refuse_stream_dtypes_with_no_kernel(cuda):
    x = _inputs(cuda, 4, 8, 2)
    for load, gen, sell in ((x["load"], x["gen"].bfloat16(), x["sell"]),
                            (x["load"].half(), x["gen"], x["sell"]),
                            (x["load"].to(torch.int8), x["gen"].to(torch.int8),
                             x["sell"].half())):
        for signed in (False, True):
            with pytest.raises(TypeError, match="kernel"):
                bk.month_sums(load, gen, sell, x["period"], x["scales"],
                              layout.FULL_OFFSETS, 2, signed)
    # int8 codes have no signed kernel (the battery run prices float32)
    q = x["load"].to(torch.int8)
    with pytest.raises(TypeError, match="signed"):
        bk.bucket_sums(q, q, x["sell"], x["bucket"], x["scales"], 24)


# ---------------------------------------------------------------------------
# The month kernel's period-partitioned staging: corner cases
# ---------------------------------------------------------------------------

def _month_lanes(offsets):
    """[L] month index of every lane."""
    return torch.repeat_interleave(
        torch.arange(12), torch.tensor(np.diff(np.asarray(offsets))))


def _month_case(period, month, p, offsets, seed):
    """Each agent's period lanes rewritten in some months: every hour of
    month 0 in the last period; no hour of month 1 in period 1 (P >= 2);
    at P >= 3 month 2 holds each period but 0 in exactly one hour, at
    random; month 3 cycles through the periods hour by hour (runs of one
    hour in lane order)."""
    g = torch.Generator().manual_seed(seed)
    period = period.clone()
    n = period.shape[0]
    period[:, month == 0] = p - 1
    if p >= 2:
        m1 = month == 1
        period[:, m1] = torch.where(period[:, m1] == 1, 0, period[:, m1])
    if p >= 3:
        lanes = torch.nonzero(month == 2)[:, 0]
        period[:, lanes] = 0
        for a in range(n):
            pick = lanes[torch.randperm(len(lanes), generator=g)[:p - 1]]
            period[a, pick] = torch.arange(1, p, dtype=torch.int32)
    m3 = torch.nonzero(month == 3)[:, 0]
    period[:, m3] = (torch.arange(len(m3), dtype=torch.int32) % p)[None, :]
    return period


@pytest.mark.parametrize("lanes", ["full", "compacted"])
@pytest.mark.parametrize("p", list(range(1, 11)))
@pytest.mark.parametrize("signed", [False, True])
def test_month_kernel_period_corners(cuda, lanes, p, signed):
    """Absent periods, a one-period month, single-hour runs and every P
    in 1..10, full-hour and on the uneven daylight-compacted lanes."""
    offsets = _offsets(lanes)
    x = _inputs(cuda, 13, 70, p, seed=20 + p, offsets=offsets)
    month = _month_lanes(offsets)
    x["period"] = _month_case(x["period"].cpu(), month, p, offsets,
                              seed=p).to(cuda)
    args = _lane_args(x, offsets, p, signed)
    got = bk.month_sums(*args)
    ref = bk.month_sums_plain(*args)
    _close(got, ref)
    imp = got[0].view(13, 70, 12, p)
    if p > 1:   # month 1 lacks period 1: its sums are exactly zero
        assert bool((imp[:, :, 1, 1] == 0).all())
        assert bool((imp[:, :, 0, :p - 1] == 0).all())   # month 0: one period


def test_month_kernel_stages_out_of_range_periods_for_sell_only(cuda):
    """A period lane outside [0, P) counts in the sell sums and in no
    bucket, as in the plain version."""
    x = _inputs(cuda, 9, 40, 3, seed=30)
    x["period"][:, ::7] = 5
    x["period"][:, 3::11] = -1
    for signed in (False, True):
        args = _lane_args(x, layout.FULL_OFFSETS, 3, signed)
        _close(bk.month_sums(*args), bk.month_sums_plain(*args))


@pytest.mark.parametrize("lanes", ["full", "compacted"])
@pytest.mark.parametrize("p", [1, 2, 10])
def test_month_kernel_sums_each_period_in_lane_order(cuda, lanes, p):
    """With every scale 0, net = load exactly (the multiply-add adds a
    zero), so each bucket is a float32 sum of the period's lanes of the
    month: equal, bit for bit, to adding them one by one in lane order —
    the summation order of the kernel's earlier per-period predicated
    adds."""
    offsets = _offsets(lanes)
    x = _inputs(cuda, 11, 3, p, seed=31, offsets=offsets)
    x["load"] = x["load"] - 1.0          # both signs: relu and signed differ
    x["scales"].zero_()
    got = bk.month_sums(*_lane_args(x, offsets, p, True))
    load = x["load"].cpu().numpy()
    bucket = (_month_lanes(offsets)[None, :] * p + x["period"].cpu()).numpy()
    imp = np.zeros((11, 12 * p), np.float32)
    sgn = np.zeros((11, 12 * p), np.float32)
    rows = np.arange(11)
    for h in range(load.shape[1]):
        imp[rows, bucket[:, h]] += np.maximum(load[:, h], np.float32(0.0))
        sgn[rows, bucket[:, h]] += load[:, h]
    for j in range(3):
        np.testing.assert_array_equal(got[0][:, j].cpu().numpy(), imp)
        np.testing.assert_array_equal(got[2][:, j].cpu().numpy(), sgn)


@pytest.mark.parametrize("spt", bk.MONTH_SCALES_PER_THREAD_FORMS)
@pytest.mark.parametrize("r", [1, 25, 300, 700])
@pytest.mark.parametrize("signed", [False, True])
def test_month_kernel_scales_per_thread_forms(cuda, spt, r, signed):
    """Every scales-per-thread form, with R past one block's scales (700
    at 2 a thread) and a ragged last warp; the forms take the lanes in
    the same order, so they agree with each other bit for bit."""
    x = _inputs(cuda, 5, r, 4, seed=32)
    args = _lane_args(x, layout.FULL_OFFSETS, 4, signed)
    key = "month_signed" if signed else "month"
    before = bk.LAUNCHES[key]
    got = bk.month_sums(*args, scales_per_thread=spt)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[key] == before + 1
    _close(got, bk.month_sums_plain(*args))
    for a, b in zip(got, bk.month_sums(*args)):
        assert torch.equal(a, b)


def test_month_kernel_forms_refuse_what_they_do_not_take(cuda):
    x = _inputs(cuda, 4, 8, 2)
    args = _lane_args(x, layout.FULL_OFFSETS, 2, False)
    with pytest.raises(ValueError, match="scales_per_thread"):
        bk.month_sums(*args, scales_per_thread=3)
    narrow = _narrow(x, bk.IMPORT_DTYPES[1])
    with pytest.raises(TypeError, match="float32"):
        bk.month_sums(*_lane_args(narrow, layout.FULL_OFFSETS, 2, False),
                      scales_per_thread=4)


# ---------------------------------------------------------------------------
# The stream and pair kernels on the month kernel's staging: bit for bit
# ---------------------------------------------------------------------------

#: R of the bitwise grids: one warp's scales and less (one agent a warp,
#: several a block), just past a warp (one agent a block, 2 a thread), the
#: refine rounds' R, and past one block's 512 scales
BITWISE_R = [1, 25, 33, 300, 700]
#: (signed, (load, gen, sell) dtypes) of every instantiated kernel
BITWISE_DTYPES = ([(False, d) for d in bk.IMPORT_DTYPES]
                  + [(True, d) for d in bk.SIGNED_DTYPES])


def _dtype_id(d):
    return "-".join(str(t).replace("torch.", "") for t in d)


def _same_bits(got, ref):
    """Every output equal bit for bit (signed zeros included)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        if not torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])):
            return False
    return True


def _bitwise_lanes(dev, lanes, n, seed):
    """(offsets, inputs) for the bitwise grids: full-hour lanes, the
    uniform compacted lanes, or those with their pad lanes zero-filled as
    the engines fill them (ops/layout.py) plus zero lanes inside the
    months: load -0.0 and gen 0 beside a negative sell rate."""
    offsets = _offsets("full" if lanes == "full" else "uniform")
    x = _inputs(dev, n, max(BITWISE_R), 10, seed=seed, offsets=offsets)
    if lanes == "padded":
        lay = layout.daylight_layout(synth.make_solar_cf_profiles(8, seed=1))
        valid = torch.from_numpy(np.array(lay.uniform().valid)).to(dev)
        g = torch.Generator().manual_seed(seed)
        hole = (torch.rand(x["load"].shape, generator=g) < 0.05).to(dev)
        x["load"] = torch.where(hole, torch.full_like(x["load"], -0.0),
                                x["load"] * valid)
        x["gen"] = torch.where(hole, 0.0, x["gen"] * valid)
        x["sell"] = torch.where(hole, -x["sell"], x["sell"] * valid)
        x["sell_b"] = x["sell_b"] * valid
    return offsets, x


@pytest.mark.parametrize("case", BITWISE_DTYPES,
                         ids=lambda c: ("signed-" if c[0] else "") + _dtype_id(c[1]))
@pytest.mark.parametrize("lanes", ["full", "uniform", "padded"])
def test_stream_kernel_equals_month_kernel_bit_for_bit(cuda, lanes, case):
    """Both kernels walk the same period runs in lane order, so they agree
    bit for bit for every stream type, P in 1..10 and R, with 43 agents;
    on padded lanes the stream kernel drops the zero lanes the month
    kernel adds."""
    signed, dtypes = case
    offsets, x = _bitwise_lanes(cuda, lanes, 43, seed=50)
    x = _narrow(x, dtypes)
    key = "stream_signed" if signed else "stream"
    for p in range(1, 11):
        period = (x["period"] % p).contiguous()
        for r in BITWISE_R:
            args = (x["load"], x["gen"], x["sell"], period,
                    x["scales"][:, :r].contiguous(), offsets, p, signed)
            ref = bk.month_sums(*args)
            before = bk.LAUNCHES[key]
            got = bk.stream_sums(*args)
            assert bk.LAUNCHES[key] == before + 1
            assert _same_bits(got, ref), (p, r)


@pytest.mark.parametrize("dtypes", bk.IMPORT_DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("lanes", ["full", "uniform", "padded"])
def test_pair_kernel_equals_two_month_launches_bit_for_bit(cuda, lanes, dtypes):
    """Each half of the pair kernel is one month-kernel launch on that
    tariff's sell and period lanes, bit for bit, for P in 1..10 and R."""
    offsets, x = _bitwise_lanes(cuda, lanes, 43, seed=51)
    x = _narrow(x, dtypes)
    for p in range(1, 11):
        pa = (x["period"] % p).contiguous()
        pb = (x["period_b"] % p).contiguous()
        for r in BITWISE_R:
            sc = x["scales"][:, :r].contiguous()
            before = bk.LAUNCHES["month_pair"]
            got = bk.month_pair_sums(x["load"], x["gen"], x["sell"], pa,
                                     x["sell_b"], pb, sc, offsets, p)
            assert bk.LAUNCHES["month_pair"] == before + 1
            ref = (bk.month_sums(x["load"], x["gen"], x["sell"], pa, sc, offsets,
                                 p, False)
                   + bk.month_sums(x["load"], x["gen"], x["sell_b"], pb, sc,
                                   offsets, p, False))
            assert _same_bits(got, ref), (p, r)


@pytest.mark.parametrize("lanes", ["full", "compacted", "uniform"])
@pytest.mark.parametrize("p", list(range(1, 11)))
@pytest.mark.parametrize("signed", [False, True])
def test_stream_and_pair_kernels_period_corners(cuda, lanes, p, signed):
    """The month kernel's period corners (absent periods, a one-period
    month, single-hour runs) through the stream kernel, and the pair
    kernel with a second corner map: each against its plain version and
    bit for bit against the month kernel, on every lane layout."""
    offsets = _offsets(lanes)
    x = _inputs(cuda, 13, 70, p, seed=20 + p, offsets=offsets)
    month = _month_lanes(offsets)
    x["period"] = _month_case(x["period"].cpu(), month, p, offsets,
                              seed=p).to(cuda)
    x["period_b"] = _month_case(x["period_b"].cpu(), month, p, offsets,
                                seed=p + 40).to(cuda)
    args = _lane_args(x, offsets, p, signed)
    got = bk.stream_sums(*args)
    _close(got, bk.month_sums_plain(*args))
    assert _same_bits(got, bk.month_sums(*args))
    imp = got[0].view(13, 70, 12, p)
    if p > 1:   # month 1 lacks period 1; month 0 holds one period
        assert bool((imp[:, :, 1, 1] == 0).all())
        assert bool((imp[:, :, 0, :p - 1] == 0).all())
    if signed:
        return
    pair = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"],
            x["period_b"], x["scales"], offsets, p)
    got = bk.month_pair_sums(*pair)
    _close(got, bk.month_pair_sums_plain(*pair))
    ref = (bk.month_sums(*args)
           + bk.month_sums(x["load"], x["gen"], x["sell_b"], x["period_b"],
                           x["scales"], offsets, p, False))
    assert _same_bits(got, ref)


def test_stream_and_pair_kernels_stage_out_of_range_periods_for_sell_only(cuda):
    """A period lane outside [0, P) counts in the sell sums and in no
    bucket, in both kernels, as in the plain versions."""
    x = _inputs(cuda, 9, 40, 3, seed=30)
    x["period"][:, ::7] = 5
    x["period"][:, 3::11] = -1
    x["period_b"][:, 1::5] = 3
    x["period_b"][:, 2::13] = -7
    for signed in (False, True):
        args = _lane_args(x, layout.FULL_OFFSETS, 3, signed)
        got = bk.stream_sums(*args)
        _close(got, bk.month_sums_plain(*args))
        assert _same_bits(got, bk.month_sums(*args))
    pair = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"],
            x["period_b"], x["scales"], layout.FULL_OFFSETS, 3)
    _close(bk.month_pair_sums(*pair), bk.month_pair_sums_plain(*pair))


# ---------------------------------------------------------------------------
# The battery dispatch kernel (battery_dispatch.cu)
# ---------------------------------------------------------------------------

def _dispatch_inputs(dev, n, hours, seed):
    rng = np.random.default_rng(seed)
    load = rng.uniform(0.1, 4.0, (n, hours)).astype(np.float32)
    gen = (rng.uniform(0.0, 3.0, (n, hours))
           * (rng.random((n, hours)) > 0.4)).astype(np.float32)
    kw = rng.uniform(0.5, 4.0, n).astype(np.float32)
    kw[0] = 0.0                                   # a zero battery
    kwh = (kw * 2.0).astype(np.float32)
    eff = rng.uniform(0.80, 0.96, n).astype(np.float32)   # mixed rt_eff
    return [torch.from_numpy(a).to(dev) for a in (load, gen, kw, kwh, eff)]


def _equal(a, b) -> bool:
    """torch.equal, with NaN equal to NaN in the same places (the NaN's
    payload may differ between the kernel's min.NaN and PyTorch's)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_loads"])
@pytest.mark.parametrize("n", [1, 31, 33, 37, 300])
@pytest.mark.parametrize("hours", [1, 31, 33, 37, 8760])
def test_dispatch_kernel_equals_plain_loop(cuda, n, hours, nan):
    """Bit for bit, at agent counts that leave the last block of 32 partly
    empty and hour counts that leave the last tile of 32 partly empty;
    with NaN loads in a few hours of two agents, NaN in the same places."""
    from dgen_tpu_torch.ops import dispatch

    x = _dispatch_inputs(cuda, n, hours, seed=n + hours)
    if nan:
        x[0][-1, hours // 2] = float("nan")
        x[0][n // 2, ::max(1, hours // 3)] = float("nan")
    before = dispatch.LAUNCHES["dispatch"]
    got = dispatch.dispatch_battery(*x)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["dispatch"] == before + 1
    ref = dispatch.dispatch_battery_plain(*x)
    for k in ("system_out", "soc", "charge", "discharge"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.shape == b.shape == (n, hours) and a.is_contiguous()
        assert _equal(a, b), (k, float((a - b).abs().nan_to_num().max()))
    if nan:
        assert bool(torch.isnan(got.soc[-1, hours // 2:]).all())
        return
    assert float(got.charge[0].abs().max()) == 0.0
    assert torch.equal(got.system_out[0], x[1][0])
    if n > 1 and hours > 1:
        assert float(got.charge.sum()) > 0.0 and float(got.discharge.sum()) > 0.0


def test_dispatch_on_the_card_runs_pscan_and_refuses_what_it_does_not_take(cuda):
    from dgen_tpu_torch.ops import dispatch

    x = _dispatch_inputs(cuda, 16, 8760, seed=40)
    before = dispatch.LAUNCHES["dispatch"]
    ps = dispatch.dispatch_battery(*x, impl="pscan")
    assert dispatch.LAUNCHES["dispatch"] == before   # plain PyTorch, no kernel
    seq = dispatch.dispatch_battery(*x)
    for k in ("soc", "charge", "discharge", "system_out"):
        np.testing.assert_allclose(getattr(ps, k).cpu().numpy(),
                                   getattr(seq, k).cpu().numpy(), rtol=1e-5,
                                   atol=2e-4 if k == "system_out" else 1e-4)
    with pytest.raises(TypeError, match="float32"):
        dispatch.dispatch_battery(x[0].double(), *x[1:])
    with pytest.raises(ValueError, match="on"):
        dispatch.dispatch_battery(x[0], x[1], x[2].cpu(), *x[3:])
    with pytest.raises(ValueError, match="shape"):
        dispatch.dispatch_battery(x[0], x[1][:, :100], *x[2:])


def test_dispatch_kernel_exact_division_tiles_equal_plain_loop(cuda):
    """Agents and tiles outside the range where the kernel divides
    through a reciprocal taken once per agent run nvcc's own division:
    a one-way efficiency below 0.5, batteries too small for the range,
    denormal and huge loads in some hours, a negative generation; still
    bit for bit the plain loop, beside agents on the fast division in
    the same warps."""
    from dgen_tpu_torch.ops import dispatch

    load, gen, kw, kwh, eff = _dispatch_inputs(cuda, 70, 8760, seed=41)
    eff[1] = 0.2                       # eta = 0.447
    kwh[2], kw[2] = 1e-20, 5e-21       # soc_min below 2^-60
    kwh[3], kw[3] = 3e20, 1.5e20       # above 2^60
    load[4, 100:140] = 1e-40           # denormal hours
    gen[5, 3000:3010] = 1e-39
    load[6, 5000] = 3e19
    gen[33, 7000:7100] = -0.5          # negative generation (allowed)
    got = dispatch.dispatch_battery(load, gen, kw, kwh, eff)
    ref = dispatch.dispatch_battery_plain(load, gen, kw, kwh, eff)
    for k in ("system_out", "soc", "charge", "discharge"):
        a, b = getattr(got, k), getattr(ref, k)
        assert torch.equal(a, b), (k, float((a - b).abs().max()))


def _nonfinite_load(x, rows=(1, 4)):
    """One agent's load NaN on three lanes, another's +Inf on one."""
    load = x["load"].clone()
    n_lanes = load.shape[1]
    load[rows[0], [3, n_lanes // 2, n_lanes - 5]] = float("nan")
    load[rows[1], n_lanes // 3] = float("inf")
    return {**x, "load": load}


@pytest.mark.parametrize("lanes", ["full", "uniform"])
@pytest.mark.parametrize("kernel", ["month", "month_signed", "stream", "stream_signed",
                                    "pair"])
def test_staged_kernels_carry_nan_and_inf_as_the_plain_versions(cuda, kernel, lanes):
    """The staged kernels' relu keeps NaN (as jnp.maximum and
    torch.clamp_min do; fmaxf would give 0): a NaN or +Inf load hour
    reaches its own (month, period) bucket and the sell sums, at exactly
    the plain version's NaN, +Inf and -Inf positions; the finite sums
    within the kernels' tolerance."""
    offsets = _offsets(lanes)
    x = _nonfinite_load(_inputs(cuda, 16, 25, 3, seed=5, offsets=offsets))
    signed = kernel.endswith("_signed")
    if kernel == "pair":
        args = (x["load"], x["gen"], x["sell"], x["period"], x["sell_b"], x["period_b"],
                x["scales"], offsets, 3)
        got, ref = bk.month_pair_sums(*args), bk.month_pair_sums_plain(*args)
    else:
        fn = bk.stream_sums if kernel.startswith("stream") else bk.month_sums
        args = _lane_args(x, offsets, 3, signed)
        got, ref = fn(*args), bk.month_sums_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        for what in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(what(g), what(r)), what.__name__
        fin = torch.isfinite(r)
        assert not bool(fin.all())
        row_max = torch.where(fin, r.abs(), torch.zeros_like(r)).flatten(1).amax(1)
        tol = 1e-4 * r.abs() + 1e-3 * row_max.view(-1, *[1] * (r.ndim - 1))
        assert bool(((g - r).abs() <= tol)[fin].all())
    assert not bool(torch.isfinite(got[0][1]).all())      # the NaN reached imports


@pytest.mark.parametrize("rate_switch_frac", [0.0, 0.4], ids=["month", "pair"])
def test_serving_answers_do_not_depend_on_the_bucket(cuda, rate_switch_frac):
    """A serving engine's answers for the same agents are the same bits at
    every bucket of 1 to 64 rows and at bucket=None: every bucket launches
    at least ``LAUNCH_ROW_FLOOR`` rows (below 16 rows PyTorch's CUDA row
    sums add a row's lanes in another order)."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.serve.engine import ServeEngine

    sim, _, _ = presets.build("ercot-all-sector", n_agents=1024, end_year=2014,
                              rate_switch_frac=rate_switch_frac, device="cuda")
    engine = ServeEngine(sim)
    rows = np.flatnonzero(sim.host_mask > 0)[::97][:3].astype(np.int32)
    ref = engine.query_rows(rows, 0)
    for bucket in (1, 2, 4, 8, 16, 32, 64):
        parts = [engine.query_rows(rows[i:i + bucket], 0, bucket=bucket)
                 for i in range(0, len(rows), bucket)]
        for f, want in ref.items():
            got = np.concatenate([p[f] for p in parts])
            assert got.tobytes() == want.tobytes(), (bucket, f)
