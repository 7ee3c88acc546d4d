"""Bill layer, cashflow and battery dispatch of the PyTorch port against
the JAX package on the CPU. The JAX engines run their XLA twin
(``impl="xla"``), as the JAX package's own CPU tests do; the port runs
the plain versions of its kernels. Bucket sums: rtol 1e-5 / atol 1e-3,
the bound the JAX package pins for two float32 reduction orders
(tests/test_billpallas.py::test_sharded_engine_matches_unsharded), for
every engine, lane layout and pack; the stream engine is also held to
the JAX stream kernel run in the Pallas interpreter, as
tests/test_roofline.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu.io import synth as jsynth
from dgen_tpu.ops import bill as jbill
from dgen_tpu.ops import billpallas as jbp
from dgen_tpu.ops import cashflow as jcf
from dgen_tpu.ops import dispatch as jdisp
from dgen_tpu.ops import sizing as jsizing
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.ops import bill as tbill
from dgen_tpu_torch.ops import billkernels as tbk
from dgen_tpu_torch.ops import cashflow as tcf
from dgen_tpu_torch.ops import dispatch as tdisp
from dgen_tpu_torch.ops import layout as tlay
from dgen_tpu_torch.ops.tariff import NET_BILLING

N = 24


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def world():
    """The same seeded world in both packages: streams, tariffs, scales."""
    jp = jsynth.generate_population(N, seed=3, pad_multiple=8)
    tp = tsynth.generate_population(N, seed=3, pad_multiple=8, device="cpu")
    jt = jp.table
    load = jp.profiles.load[jt.load_idx] * jt.load_kwh_per_customer_in_bin[:, None]
    gen = jp.profiles.solar_cf[jt.cf_idx] * jsizing.INV_EFF
    ts = jp.profiles.wholesale[jt.region_idx]
    jat = jax.vmap(lambda k: jbill.gather_tariff(jp.tariffs, k))(jt.tariff_idx)
    tat = tbill.gather_tariff(tp.tariffs, tp.table.tariff_idx)
    p = jp.tariffs.max_periods
    jbucket = jbp.hourly_bucket_ids(jat.hour_period, p)
    jsell = jbp.sell_rate_hourly(jat, ts)
    rng = np.random.default_rng(0)
    scales = np.abs(rng.normal(2.0, 1.5, (load.shape[0], 7))).astype(np.float32)
    return dict(
        p=p, jat=jat, tat=tat, load=load, gen=gen, ts=ts,
        jbucket=jbucket, jsell=jsell, scales=scales,
        tload=t(load), tgen=t(gen), tts=t(ts),
        tbucket=tbk.hourly_bucket_ids(tat.hour_period, p),
        tsell=tbk.sell_rate_hourly(tat, t(ts)),
        lay_j=jbp.daylight_layout(np.asarray(jp.profiles.solar_cf)),
        lay_t=tlay.daylight_layout(tp.profiles.solar_cf.numpy()),
    )


def close(a, b, rtol=1e-5, atol=1e-3, msg=""):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_hour_streams_equal(world):
    w = world
    np.testing.assert_array_equal(np.asarray(w["jbucket"]), w["tbucket"].numpy())
    np.testing.assert_array_equal(np.asarray(w["jsell"]), w["tsell"].numpy())
    assert w["tbucket"].dtype == torch.int32


@pytest.mark.parametrize("engine", ["import_sums", "bucket_sums", "import_sums_pair"])
def test_engines_match_reference(world, engine):
    w = world
    b = 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    if engine == "import_sums":
        ref = jbp.import_sums(w["load"], w["gen"], w["jsell"], w["jbucket"], sc, b,
                              impl="xla")
        got = tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                              t(sc), b)
    elif engine == "bucket_sums":
        ref = jbp.bucket_sums(w["load"], w["gen"], w["jsell"], w["jbucket"], sc, b,
                              impl="xla")
        got = tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                              t(sc), b)
    else:
        # the second structure: a shifted period map and the wholesale rate
        jb2 = (w["jbucket"] + 1) % b
        tb2 = (w["tbucket"] + 1) % b
        ref = jbp.import_sums_pair(w["load"], w["gen"], w["jsell"], w["jbucket"],
                                   w["ts"], jb2, sc, b, impl="xla")
        got = tbk.import_sums_pair(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                                   w["tts"], tb2.to(torch.int32), t(sc), b)
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert tuple(r.shape) == tuple(g.shape)
        close(r, g, msg=f"{engine} output {i}")


def test_period_count_one_corner(world):
    """P = 1: every bucket is the month total."""
    w = world
    hp = torch.zeros_like(w["tat"].hour_period)
    tb = tbk.hourly_bucket_ids(hp, 1)
    jb = jbp.hourly_bucket_ids(jnp.zeros_like(w["jat"].hour_period), 1)
    sc = w["scales"]
    ref = jbp.bucket_sums(w["load"], w["gen"], w["jsell"], jb, jnp.asarray(sc), 12,
                          impl="xla")
    got = tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"], tb, t(sc), 12)
    for r, g in zip(ref, got):
        close(r, g)
    month_net = (w["tload"] - t(sc)[:, :1] * w["tgen"])
    totals = torch.stack([month_net[:, a:b].sum(1) for a, b in zip(
        [0, 744, 1416, 2160, 2880, 3624, 4344, 5088, 5832, 6552, 7296, 8016],
        [744, 1416, 2160, 2880, 3624, 4344, 5088, 5832, 6552, 7296, 8016, 8760])], 1)
    close(totals, got[0][:, 0], rtol=1e-5, atol=1e-2)


def test_linear_sums_and_bills_from_sums(world):
    w = world
    p, b = w["p"], 12 * w["p"]
    ref_lin = jbp.linear_sums(w["load"], w["gen"], w["jsell"], w["jat"].hour_period, p)
    lin = tbk.linear_sums(w["tload"], w["tgen"], w["tsell"], w["tat"].hour_period, p)
    for r, g in zip(ref_lin, lin):
        close(r, g, atol=0.0)
    sc = w["scales"]
    s, i, c = tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                              t(sc), b)
    bills = tbk.bills_from_sums(s, i, c, w["tat"], p)
    js, ji, jc = jbp.bucket_sums(w["load"], w["gen"], w["jsell"], w["jbucket"],
                                 jnp.asarray(sc), b, impl="xla")
    ref = jbp.bills_from_sums(js, ji, jc, w["jat"], p)
    # bills inherit the sums' bound: rtol 1e-5, atol $0.001
    close(ref, bills)
    # the search path's reduced bills on the same sums
    imp, imp_sell = tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                                    t(sc), b)
    close(jbp.bills_linear_nb(ref_lin, ji, jbp.import_sums(
        w["load"], w["gen"], w["jsell"], w["jbucket"], jnp.asarray(sc), b,
        impl="xla")[1], jnp.asarray(sc), w["jat"], p),
        tbk.bills_linear_nb(lin, imp, imp_sell, t(sc), w["tat"], p))
    close(jbp.bills_linear_nem(ref_lin, jnp.asarray(sc), w["jat"], p),
          tbk.bills_linear_nem(lin, t(sc), w["tat"], p))
    # and against the direct hourly bill oracle, both packages
    for y in range(sc.shape[1]):
        net = w["tload"] - t(sc[:, y])[:, None] * w["tgen"]
        oracle = tbill.annual_bill(net, w["tat"], w["tts"], p)
        close(oracle, bills[:, y], rtol=5e-4, atol=1.0)
        ref_y = jax.vmap(
            lambda l, g, tt, sl, s_: jbill.annual_bill(l - s_ * g, tt, sl, p)
        )(w["load"], w["gen"], w["jat"], w["ts"], jnp.asarray(sc[:, y]))
        close(ref_y, oracle, rtol=1e-5, atol=1e-2)


def test_zero_scale_is_no_system_bill(world):
    w = world
    p = w["p"]
    zeros = torch.zeros((N, 1))
    s, i, c = tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                              zeros, 12 * p)
    bills = tbk.bills_from_sums(s, i, c, w["tat"], p)[:, 0]
    ref = tbill.annual_bill(w["tload"], w["tat"], w["tts"], p)
    close(ref, bills, rtol=1e-5, atol=0.1)
    assert torch.allclose(c[:, 0], torch.zeros(N), atol=1e-3)
    assert (w["tat"].metering == NET_BILLING).any()


@pytest.fixture(scope="module")
def finance():
    rng = np.random.default_rng(1)
    b, y = 64, 25
    f32 = np.float32
    fin = dict(
        down_payment_fraction=rng.choice([0.2, 1.0], b).astype(f32),
        loan_interest_rate=rng.choice([0.0, 0.05, 0.08], b).astype(f32),
        loan_term_yrs=rng.choice([10, 20], b).astype(np.int32),
        real_discount_rate=rng.uniform(0.02, 0.08, b).astype(f32),
        inflation_rate=np.full(b, 0.025, f32),
        tax_rate=rng.uniform(0.2, 0.35, b).astype(f32),
        itc_fraction=rng.choice([0.0, 0.3], b).astype(f32),
        is_commercial=rng.choice([0.0, 1.0], b).astype(f32),
        om_per_year=rng.uniform(0, 50, b).astype(f32),
        deprec_sch=np.tile(jcf.MACRS_5, (b, 1)),
    )
    inc = dict(
        cbi_usd_p_w=rng.uniform(0, 0.5, (b, 2)).astype(f32),
        cbi_max_usd=rng.uniform(500, 5000, (b, 2)).astype(f32),
        ibi_frac=rng.uniform(0, 0.2, (b, 2)).astype(f32),
        ibi_max_usd=rng.uniform(500, 5000, (b, 2)).astype(f32),
        pbi_usd_p_kwh=rng.uniform(0, 0.05, (b, 2)).astype(f32),
        pbi_years=rng.integers(0, 10, (b, 2)).astype(np.int32),
        pbi_decay=rng.choice([0.0, 1.0], (b, 2)).astype(f32),
    )
    args = dict(
        energy_value=rng.uniform(-200, 3000, (b, y)).astype(f32),
        installed_cost=rng.uniform(5e3, 4e4, b).astype(f32),
        system_kw=rng.uniform(2, 12, b).astype(f32),
        annual_kwh=rng.uniform(2e3, 2e4, b).astype(f32),
        degradation=np.full(b, 0.005, f32),
    )
    ref = jax.vmap(lambda ev, c, fn, kw, kwh, dg, ic: jcf.cashflow(
        ev, c, fn, y, system_kw=kw, annual_kwh=kwh, degradation=dg, inc=ic))(
        args["energy_value"], args["installed_cost"], jcf.FinanceParams(**fin),
        args["system_kw"], args["annual_kwh"], args["degradation"],
        jcf.IncentiveParams(**inc))
    got = tcf.cashflow(
        t(args["energy_value"]), t(args["installed_cost"]),
        tcf.FinanceParams(**{k: t(v) for k, v in fin.items()}), y,
        system_kw=t(args["system_kw"]), annual_kwh=t(args["annual_kwh"]),
        degradation=t(args["degradation"]),
        inc=tcf.IncentiveParams(**{k: t(v) for k, v in inc.items()}))
    return ref, got


def test_cashflow_matches_reference(finance):
    ref, got = finance
    for k in ("cf", "payments", "interest", "itc", "depreciation"):
        close(ref[k], got[k], atol=0.0, msg=k)
    # NPV is a sum of +/- flows: its float32 error scales with the flows
    flow = np.abs(np.asarray(ref["cf"])).sum(axis=1)
    err = np.abs(got["npv"].numpy() - np.asarray(ref["npv"]))
    assert np.all(err <= 1e-5 * np.abs(np.asarray(ref["npv"])) + 1e-6 * flow)


def test_payback_on_the_grid_and_equal(finance):
    ref, got = finance
    pp = tcf.payback_period(got["cf"]).numpy()
    ref_pp = np.asarray(jax.vmap(jcf.payback_period)(ref["cf"]))
    np.testing.assert_array_equal(pp, ref_pp)
    # every value sits on the 0.1-year grid (never-payback is 30.1)
    np.testing.assert_array_equal(pp, np.round(pp * 10.0).astype(np.float32) / 10.0)
    assert len(np.unique(pp)) > 5


def test_loan_schedule_zero_rate():
    pay, inte = tcf.loan_schedule(t(np.float32([1000.0])), t(np.float32([0.0])),
                                  t(np.int32([4])), 6)
    np.testing.assert_allclose(pay.numpy()[0], [250, 250, 250, 250, 0, 0])
    np.testing.assert_allclose(inte.numpy()[0], 0.0)


def test_dispatch_matches_reference(world):
    w = world
    rng = np.random.default_rng(2)
    kw = rng.uniform(2.0, 9.0, N).astype(np.float32)
    gen = np.asarray(w["gen"]) * kw[:, None]
    bkw, bkwh = tdisp.batt_size_from_pv(t(kw))
    rt = np.full(N, 0.9216, np.float32)
    got = tdisp.dispatch_battery(w["tload"], t(gen), bkw, bkwh, t(rt))
    ref = jax.vmap(jdisp.dispatch_battery)(
        w["load"], jnp.asarray(gen), jnp.asarray(bkw.numpy()),
        jnp.asarray(bkwh.numpy()), jnp.asarray(rt))
    for k in ("system_out", "soc", "charge", "discharge"):
        close(getattr(ref, k), getattr(got, k), rtol=1e-5, atol=1e-4, msg=k)
    assert float(got.charge.sum()) > 0.0 and float(got.discharge.sum()) > 0.0


def _layouts(w, kind):
    if kind == "full":
        return None, None
    if kind == "compacted":
        return w["lay_j"], w["lay_t"]
    return w["lay_j"].uniform(), w["lay_t"].uniform()


def _second_structure(w):
    """Month-major bucket ids of a second tariff structure (each hour's
    period moved on by one), in both packages."""
    p = w["p"]
    jb = w["jbucket"]
    tb = w["tbucket"]
    return (jb // p * p + (jb % p + 1) % p,
            (tb // p * p + (tb % p + 1) % p).to(torch.int32))


def _ref_pair(out):
    """A JAX engine's [N, R, 128] output -> (bucket sums, sell sums)."""
    out = np.asarray(out)
    return out[..., :jbp.SELL_COL - 1], out[..., jbp.SELL_COL]


@pytest.mark.parametrize("impl", ["auto", "stream"])
@pytest.mark.parametrize("kind", ["full", "compacted", "uniform"])
def test_lane_engines_match_reference(world, impl, kind):
    """Month and stream engines on full-hour and compacted lanes (night
    sums added back) against _sums_xla and the XLA pair engine with the
    same layout."""
    w = world
    b = 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    lay_j, lay_t = _layouts(w, kind)
    assert kind == "full" or lay_t.n_lanes < 8760
    ref = jbp.import_sums(w["load"], w["gen"], w["jsell"], w["jbucket"], sc, b,
                          impl="xla", layout=lay_j)
    got = tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"], t(sc),
                          b, impl=impl, layout=lay_t)
    for r, g in zip(ref, got):
        close(r, g)
    jb2, tb2 = _second_structure(w)
    ref = jbp.import_sums_pair(w["load"], w["gen"], w["jsell"], w["jbucket"],
                               w["ts"], jb2, sc, b, impl="xla", layout=lay_j)
    got = tbk.import_sums_pair(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                               w["tts"], tb2, t(sc), b, impl=impl, layout=lay_t)
    for r, g in zip(ref, got):
        close(r, g)


def test_stream_engine_matches_the_pallas_stream_kernel(world):
    """The stream engine's plain version against _sums_pallas_stream in
    the Pallas interpreter: imports on the uniform compacted lanes,
    signed sums on full-hour lanes."""
    w = world
    p, b = w["p"], 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    lay_j, lay_t = _layouts(w, "uniform")
    (imp_r,) = jbp._sums_pallas_stream(w["load"], w["gen"], w["jsell"],
                                       w["jbucket"], sc, with_signed=False,
                                       n_periods=p, layout=lay_j, interpret=True)
    got = tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"], t(sc), b,
                          impl="stream", layout=lay_t)
    ref = _ref_pair(imp_r)
    close(ref[0][..., :b], got[0])
    close(ref[1], got[1])
    imp_r, sgn_r = jbp._sums_pallas_stream(w["load"], w["gen"], w["jsell"],
                                           w["jbucket"], sc, with_signed=True,
                                           n_periods=p, interpret=True)
    sgn, imp, credit = tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"],
                                       w["tbucket"], t(sc), b, impl="stream")
    (ri, ris), (rs, rss) = _ref_pair(imp_r), _ref_pair(sgn_r)
    close(ri[..., :b], imp)
    close(rs[..., :b], sgn)
    close(ris - rss, credit)


@pytest.mark.parametrize("kind", ["full", "uniform"])
def test_packed_engines_match_reference(world, kind):
    """Engines fed a pack-once bundle: the JAX engines with the same
    pack, and the port's own unpacked call."""
    w = world
    b = 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    lay_j, lay_t = _layouts(w, kind)
    jb2, tb2 = _second_structure(w)
    pk_j = jbp.pack_streams(w["load"], w["gen"], w["jsell"], w["jbucket"], b,
                            layout=lay_j, sell_b=w["ts"], bucket_b=jb2)
    pk_t = tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], w["tbucket"], b,
                            layout=lay_t, sell_b=w["tts"], bucket_b=tb2)
    ref = jbp.import_sums(None, None, None, None, sc, b, impl="xla", layout=lay_j,
                          packed=pk_j)
    got = tbk.import_sums(None, None, None, None, t(sc), b, impl="stream",
                          layout=lay_t, packed=pk_t)
    unpacked = tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                               t(sc), b, layout=lay_t)
    for r, g, u in zip(ref, got, unpacked):
        close(r, g)
        torch.testing.assert_close(g, u, rtol=1e-6, atol=1e-4)
    ref = jbp.import_sums_pair(None, None, None, None, None, None, sc, b,
                               impl="xla", layout=lay_j, packed=pk_j)
    got = tbk.import_sums_pair(None, None, None, None, None, None, t(sc), b,
                               layout=lay_t, packed=pk_t)
    for r, g in zip(ref, got):
        close(r, g)
    if kind == "full":
        # the battery run's reuse: packed load/sell/period, a fresh gen
        gen2 = np.random.default_rng(5).random(w["load"].shape).astype(np.float32)
        pk1 = tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], w["tbucket"], b)
        ref = jbp.bucket_sums(w["load"], jnp.asarray(gen2), w["jsell"], w["jbucket"],
                              sc, b, impl="xla")
        got = tbk.bucket_sums(None, t(gen2), None, None, t(sc), b, packed=pk1)
        for r, g in zip(ref, got):
            close(r, g)


def test_pack_misuse_is_refused(world):
    w = world
    b = 12 * w["p"]
    sc = t(w["scales"])
    pk_full = tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], w["tbucket"], b)
    pk_comp = tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], w["tbucket"], b,
                               layout=w["lay_t"])
    with pytest.raises(ValueError, match="lanes"):
        tbk.import_sums(None, None, None, None, sc, b, layout=w["lay_t"],
                        packed=pk_full)
    with pytest.raises(ValueError, match="lanes"):   # battery run, compacted pack
        tbk.bucket_sums(None, w["tgen"], None, None, sc, b, packed=pk_comp)
    with pytest.raises(ValueError, match="packed"):
        tbk.import_sums(None, None, None, None, sc, b, impl="dot", packed=pk_full)
    with pytest.raises(ValueError, match="impl"):
        tbk.import_sums(w["tload"], w["tgen"], w["tsell"], w["tbucket"], sc, b,
                        impl="pallas")


@pytest.mark.parametrize("impl", tbk.IMPLS)
def test_engines_refuse_int64_bucket_ids(world, impl):
    """The kernels read int32 bucket ids; every entry refuses others on
    any device rather than casting them."""
    w = world
    b = 12 * w["p"]
    sc = t(w["scales"])
    wide = w["tbucket"].long()
    with pytest.raises(TypeError, match="int32"):
        tbk.import_sums(w["tload"], w["tgen"], w["tsell"], wide, sc, b, impl=impl)
    with pytest.raises(TypeError, match="int32"):
        tbk.bucket_sums(w["tload"], w["tgen"], w["tsell"], wide, sc, b, impl=impl)
    with pytest.raises(TypeError, match="int32"):
        tbk.import_sums_pair(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                             w["tsell"], wide, sc, b, impl=impl)
    with pytest.raises(TypeError, match="int32"):
        tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], wide, b)


@pytest.mark.parametrize("engine", ["import_sums", "bucket_sums", "import_sums_pair"])
def test_dot_engine_matches_reference(world, engine):
    """The one-hot dot engine's plain version against _sums_xla; it
    ignores a layout (full-hour totals)."""
    w = world
    b = 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    args_j = (w["load"], w["gen"], w["jsell"], w["jbucket"])
    args_t = (w["tload"], w["tgen"], w["tsell"], w["tbucket"])
    if engine == "import_sums_pair":
        jb2, tb2 = _second_structure(w)
        args_j += (w["ts"], jb2)
        args_t += (w["tts"], tb2)
    ref = getattr(jbp, engine)(*args_j, sc, b, impl="xla")
    got = getattr(tbk, engine)(*args_t, t(sc), b, impl="dot")
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        close(r, g)
    if engine == "import_sums":
        laid = tbk.import_sums(*args_t, t(sc), b, impl="dot", layout=w["lay_t"])
        for g, gl in zip(got, laid):
            assert torch.equal(g, gl)
