"""Bill layer, cashflow and battery dispatch of the PyTorch port against
the JAX package on the CPU. The JAX engines run their XLA twin
(``impl="xla"``), as the JAX package's own CPU tests do; the port runs
the plain versions of its kernels. Bucket sums: rtol 1e-5 / atol 1e-3,
the bound the JAX package pins for two float32 reduction orders
(tests/test_billpallas.py::test_sharded_engine_matches_unsharded)."""

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
