"""The per-agent sizing oracle of the PyTorch port against the JAX
package's on the CPU: the analysis period's bills (``bill_series``,
``escalation_factors``, ``degradation_factors``), the row-wise
``tiered_charge`` against JAX's ``einsum`` form, ``golden_section_max``,
``pv_only_npv`` and ``size_one_agent`` (vmapped in JAX, batched over
agent chunks in the port), the oracle's refusals, and the port's fast
path held to its own slow path as tests/test_sizing.py holds JAX's; and
the bill layer's smooth twin (``soft_tau``): the soft bucket sums and
bills against JAX's XLA engine at the same temperature, the soft
payback, the interpolated max-market-share lookup, and the soft-mode
refusals (stream, dot, daylight, packed, int8) of both packages.

Tolerances: bills rtol 1e-5 / atol 1e-2, the bound
tests/test_torch_bill.py pins between the two packages' hourly bill
oracles; tier charges rtol 1e-5 / atol 1e-3 (the einsum and the row-wise
sums add the same float32 terms in another order); the golden-section
points within 1e-5 (the same float32 recurrence); NPV within 1e-4 x |npv|
+ 1e-4 x the flow scale and sizes rtol 1e-4 (tests/test_torch_sizing.py);
the fast path against the slow one at tests/test_sizing.py:117-128's
bounds. The export credit, a difference of two sell-weighted sums, is
held at rtol 1e-5 of those sums."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models import simulation as jsim
from dgen_tpu.models import market as jmarket
from dgen_tpu.ops import bill as jbill
from dgen_tpu.ops import billpallas as jbp
from dgen_tpu.ops import cashflow as jcf
from dgen_tpu.ops import sizing as jsizing
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.grad.__main__ import _world_envs
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import market as tmarket
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models import simulation as tsim
from dgen_tpu_torch.ops import bill as tbill
from dgen_tpu_torch.ops import billkernels as tbk
from dgen_tpu_torch.ops import cashflow as tcf
from dgen_tpu_torch.ops import layout as tlay
from dgen_tpu_torch.ops import sizing as tsizing
from dgen_tpu_torch.tree import tree_map

N = 8
YEARS = 25
TAU = 0.1


def t(x):
    return torch.from_numpy(np.array(x))


def close(ref, got, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def tgrad(f, x):
    """d sum(f) / dx at ``x`` (a numpy array) in the port."""
    xt = t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(f(xt).sum(), xt)
    return g.numpy()


@pytest.fixture(scope="module")
def world():
    """One seeded world in both packages: first-year economics of N
    agents, half of the residential ones on a DG-rate switch, a closed
    NEM gate for a third (net billing); the JAX environment with its
    None windows filled, as ``size_agents`` fills them."""
    rng = np.random.default_rng(9)
    over = {"elec_price_escalator": np.full((2, 10, 3), 0.01, np.float32),
            "value_of_resiliency": rng.uniform(0, 40, (2, 153)).astype(np.float32)}
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2016)
    cfg_t = tcfg.ScenarioConfig(start_year=2014, end_year=2016)
    jp = jsynth.generate_population(N, seed=5, pad_multiple=8, rate_switch_frac=0.5)
    tp = tsynth.generate_population(N, seed=5, pad_multiple=8, rate_switch_frac=0.5,
                                    device="cpu")
    jin = jscen.uniform_inputs(cfg_j, n_groups=153, n_regions=10, overrides=over)
    tin = tscen.uniform_inputs(cfg_t, n_groups=153, n_regions=10, overrides=over,
                               device="cpu")
    nem = (rng.random(N) > 0.33).astype(np.float32)
    jenv = jax.jit(lambda tbl, prof, tar, inp, g: jsizing._fill_env_defaults(
        jsim.build_econ_inputs(tbl, prof, tar, jscen.apply_year(tbl, inp, 1), g,
                               tbl.incentives, rate_switch=True)))(
        jp.table, jp.profiles, jp.tariffs, jin, jnp.asarray(nem))
    tenv = tsizing._fill_env_defaults(tsim.build_econ_inputs(
        tp.table, tp.profiles, tp.tariffs, tscen.apply_year(tp.table, tin, 1),
        torch.from_numpy(nem), tp.table.incentives, rate_switch=True))
    assert jenv.tariff_w is not None
    return dict(jenv=jenv, tenv=tenv, p=int(jp.tariffs.max_periods))


@pytest.fixture(scope="module")
def oracles(world):
    """Both packages' per-agent oracle on the world (n_iters 14)."""
    w = world
    ref = jsizing.size_agents(w["jenv"], n_periods=w["p"], n_years=YEARS, fast=False)
    got = tsizing.size_agents(w["tenv"], n_periods=w["p"], n_years=YEARS, fast=False)
    return ref, got


def test_escalation_and_degradation_factors_match_reference():
    rng = np.random.default_rng(1)
    infl, esc, deg = (rng.uniform(0.0, 0.05, 6).astype(np.float32) for _ in range(3))
    ref_p = jax.vmap(lambda i, e: jbill.escalation_factors(YEARS, i, e))(infl, esc)
    ref_d = jax.vmap(lambda d: jbill.degradation_factors(YEARS, d))(deg)
    # the same float32 power: within float32 rounding of the exponent
    close(ref_p, tbill.escalation_factors(YEARS, t(infl), t(esc)), 1e-6, 0.0)
    close(ref_d, tbill.degradation_factors(YEARS, t(deg)), 1e-6, 0.0)


@pytest.mark.parametrize("soft_tau", [None, 0.1], ids=["hard", "soft"])
def test_bill_series_matches_reference(world, soft_tau):
    """Both metering styles, the switched tariff with the no-system bill
    on the original (``tariff_wo``), hard and smooth."""
    w = world
    je, te, p = w["jenv"], w["tenv"], w["p"]
    rng = np.random.default_rng(2)
    kw = rng.uniform(2.0, 40.0, N).astype(np.float32)
    j_out = je.gen_per_kw * jnp.asarray(kw)[:, None] * jsizing.INV_EFF
    t_out = te.gen_per_kw * t(kw)[:, None] * tsizing.INV_EFF
    ref = jax.vmap(lambda l, o, tw, tt, ts, i, e, d: jbill.bill_series(
        l, o, tw, ts, i, e, d, n_periods=p, n_years=YEARS, tariff_wo=tt,
        soft_tau=soft_tau))(je.load, j_out, je.tariff_w, je.tariff, je.ts_sell,
                            je.fin.inflation_rate, je.elec_price_escalator,
                            je.pv_degradation)
    got = tbill.bill_series(te.load, t_out, te.tariff_w, te.ts_sell,
                            te.fin.inflation_rate, te.elec_price_escalator,
                            te.pv_degradation, p, YEARS, tariff_wo=te.tariff,
                            soft_tau=soft_tau)
    for r, g, name in zip(ref, got, ("bills_w", "bills_wo")):
        assert tuple(r.shape) == tuple(g.shape) == (N, YEARS)
        close(r, g, 1e-5, 1e-2, name)


def test_tiered_charge_is_rowwise_and_matches_the_einsum():
    """The port's loop over tiers with row-wise sums against JAX's
    ``einsum`` form, hard and smooth; one row priced alone equals the same
    row priced among 64, bit for bit."""
    rng = np.random.default_rng(4)
    n, p, tiers = 64, 3, 4
    sums = rng.normal(300.0, 500.0, (n, 12, p)).astype(np.float32)
    price = rng.uniform(0.05, 0.3, (n, p, tiers)).astype(np.float32)
    caps = np.sort(rng.uniform(100.0, 900.0, (n, tiers)), axis=1).astype(np.float32)
    caps[:, -1] = 1e38
    for tau in (None, 5.0):
        ref = jax.vmap(lambda s, pr, c: jbill.tiered_charge(s, pr, c, tau))(
            sums, price, caps)
        got = tbill.tiered_charge(t(sums), t(price), t(caps), tau)
        close(ref, got, 1e-5, 1e-3, f"tau {tau}")
        for i in (0, 17, 63):
            alone = tbill.tiered_charge(t(sums[i:i + 1]), t(price[i:i + 1]),
                                        t(caps[i:i + 1]), tau)
            assert torch.equal(alone[0], got[i]), (tau, i)


def test_annual_bill_row_alone_equals_row_in_batch(world):
    te, p = world["tenv"], world["p"]
    batch = tbill.annual_bill(te.load, te.tariff, te.ts_sell, p)
    one = tbill.annual_bill(te.load[3:4], tbill.AgentTariff(*(x[3:4] for x in te.tariff)),
                            te.ts_sell[3:4], p)
    assert torch.equal(one[0], batch[3])


def test_golden_section_max_matches_reference():
    f_t = lambda x: -((x - 3.7) ** 2)
    got = tsizing.golden_section_max(f_t, torch.tensor(0.0), torch.tensor(10.0), 20)
    ref = jsizing.golden_section_max(lambda x: -((x - 3.7) ** 2), jnp.float32(0.0),
                                     jnp.float32(10.0), 20)
    assert abs(float(got) - float(ref)) <= 1e-5
    assert float(got) == pytest.approx(3.7, abs=1e-3)
    # batched, a bracket and an optimum per element (JAX vmaps it)
    tops = np.asarray([1.0, 5.0, 9.5], np.float32)
    lo, hi = np.zeros(3, np.float32), np.full(3, 10.0, np.float32)
    ref = jax.vmap(lambda l, h, c: jsizing.golden_section_max(
        lambda x: -((x - c) ** 2), l, h, 20))(lo, hi, tops)
    got = tsizing.golden_section_max(lambda x: -((x - t(tops)) ** 2), t(lo), t(hi), 20)
    close(ref, got, 0.0, 1e-5)
    close(tops, got, 0.0, 1e-3)


def test_pv_only_npv_matches_reference(world):
    w = world
    rng = np.random.default_rng(3)
    kw = rng.uniform(2.0, 40.0, N).astype(np.float32)
    ref = jax.vmap(lambda k, e: jsizing.pv_only_npv(k, e, w["p"], YEARS))(
        jnp.asarray(kw), w["jenv"])
    got = tsizing.pv_only_npv(t(kw), w["tenv"], w["p"], YEARS)
    flow = 25.0 * np.abs(np.asarray(jax.vmap(lambda e: jbill.annual_bill(
        e.load, e.tariff, e.ts_sell, w["p"]))(w["jenv"])))
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(ref)),
                                 1e-4 * np.abs(np.asarray(ref)) + 1e-4 * flow + 1e-6)


def test_size_one_agent_matches_reference(world, oracles):
    """``size_agents(fast=False)``: JAX vmaps ``size_one_agent``; the port
    batches it (the battery run through ``dispatch_battery``)."""
    ref, got = oracles
    close(ref.system_kw, got.system_kw, 1e-4, 0.0, "system_kw")
    flow = 25.0 * np.abs(np.asarray(ref.first_year_bill_without_system))
    np.testing.assert_array_less(np.abs(got.npv.numpy() - np.asarray(ref.npv)),
                                 1e-4 * np.abs(np.asarray(ref.npv)) + 1e-4 * flow + 1e-6)
    close(ref.payback_period, got.payback_period, 0.0, 0.1 + 1e-6, "payback")
    for k in ("first_year_bill_with_system", "first_year_bill_without_system",
              "first_year_bill_with_batt"):
        close(getattr(ref, k), getattr(got, k), 1e-4, 1e-2, k)
    for k in ("batt_kw", "batt_kwh", "naep", "annual_energy_production_kwh"):
        close(getattr(ref, k), getattr(got, k), 1e-4, 1e-4, k)
    for k in ("baseline_net_hourly", "adopter_net_hourly_pvonly",
              "adopter_net_hourly_with_batt"):
        assert tuple(getattr(got, k).shape) == (N, 8760)
        close(getattr(ref, k), getattr(got, k), 1e-4, 1e-3, k)
    assert tuple(got.cash_flow.shape) == (N, YEARS + 1)


def test_oracle_rows_do_not_depend_on_their_chunk(world, oracles, monkeypatch):
    """Chunks of 3 rows (the last one of 2) give the whole-table oracle's
    results bit for bit."""
    w = world
    per_row = tsizing.ORACLE_TEMPS * YEARS * 8760 * 4
    monkeypatch.setattr(tsizing, "ORACLE_BYTES", 3 * per_row)
    assert tsizing.oracle_chunk_rows(YEARS) == 3
    chunked = tsizing.size_agents(w["tenv"], n_periods=w["p"], n_years=YEARS,
                                  fast=False, keep_hourly=False)
    whole = oracles[1]
    for k in ("system_kw", "npv", "payback_period", "first_year_bill_with_batt",
              "energy_value_pv_batt"):
        assert torch.equal(getattr(chunked, k), getattr(whole, k)), k


def test_oracle_refusals_match_reference(world):
    """int8 banks and ``soft_tau`` are fast-path representations in both
    packages."""
    w = world
    for pkg, env in ((jsizing, w["jenv"]), (tsizing, w["tenv"])):
        ones = jnp.ones(N) if pkg is jsizing else torch.ones(N)
        with pytest.raises(ValueError, match="int8 quantized banks"):
            pkg.size_agents(dataclasses.replace(env, load_scale=ones, gen_scale=ones),
                            n_periods=w["p"], n_years=YEARS, fast=False)
        with pytest.raises(ValueError, match="soft_tau is a fast-path knob"):
            pkg.size_agents(env, n_periods=w["p"], n_years=YEARS, fast=False,
                            soft_tau=0.1)


# the smooth twin of the bill layer

@pytest.fixture(scope="module")
def bill_world():
    """tests/test_torch_bill.py's world: 24 agents' streams, tariffs and
    scales in both packages."""
    jp = jsynth.generate_population(24, seed=3, pad_multiple=8)
    tp = tsynth.generate_population(24, seed=3, pad_multiple=8, device="cpu")
    jt = jp.table
    load = jp.profiles.load[jt.load_idx] * jt.load_kwh_per_customer_in_bin[:, None]
    gen = jp.profiles.solar_cf[jt.cf_idx] * jsizing.INV_EFF
    ts = jp.profiles.wholesale[jt.region_idx]
    jat = jax.vmap(lambda k: jbill.gather_tariff(jp.tariffs, k))(jt.tariff_idx)
    tat = tbill.gather_tariff(tp.tariffs, tp.table.tariff_idx)
    p = jp.tariffs.max_periods
    rng = np.random.default_rng(0)
    scales = np.abs(rng.normal(2.0, 1.5, (load.shape[0], 7))).astype(np.float32)
    return dict(p=p, jat=jat, tat=tat, load=load, gen=gen, ts=ts, scales=scales,
                jbucket=jbp.hourly_bucket_ids(jat.hour_period, p),
                jsell=jbp.sell_rate_hourly(jat, ts),
                tload=t(load), tgen=t(gen), tts=t(ts),
                tbucket=tbk.hourly_bucket_ids(tat.hour_period, p),
                tsell=tbk.sell_rate_hourly(tat, t(ts)),
                bank=tp.profiles.solar_cf.numpy())


def test_soft_sums_and_bills_match_reference(bill_world):
    """``soft_tau`` through every engine entry (on the plain
    differentiable sums) and every bill built from sums, against the JAX
    package's XLA engine under the same temperature; the plain engine's
    hard sums against the month kernel's plain version."""
    w = bill_world
    b, p = 12 * w["p"], w["p"]
    sc = jnp.asarray(w["scales"])
    jargs = (w["load"], w["gen"], w["jsell"], w["jbucket"], sc, b)
    targs = (w["tload"], w["tgen"], w["tsell"], w["tbucket"], t(sc), b)
    for tau in (TAU,):
        ref = jbp.import_sums(*jargs, impl="xla", soft_tau=tau)
        got = tbk.import_sums(*targs, soft_tau=tau)
        for r, g in zip(ref, got):
            close(r, g, 1e-5, 1e-3, f"import_sums tau {tau}")
        lin_j = jbp.linear_sums(w["load"], w["gen"], w["jsell"], w["jat"].hour_period, p)
        lin_t = tbk.linear_sums(w["tload"], w["tgen"], w["tsell"], w["tat"].hour_period, p)
        close(jbp.bills_linear_nb(lin_j, *ref, sc, w["jat"], p, tau),
              tbk.bills_linear_nb(lin_t, *got, t(sc), w["tat"], p, tau), 1e-5, 1e-3)
        close(jbp.bills_linear_nem(lin_j, sc, w["jat"], p, tau),
              tbk.bills_linear_nem(lin_t, t(sc), w["tat"], p, tau), 1e-5, 1e-3)
        js = jbp.bucket_sums(*jargs, impl="xla", soft_tau=tau)
        ts_ = tbk.bucket_sums(*targs, impl="plain", soft_tau=tau)
        for r, g in zip(js[:2], ts_[:2]):
            close(r, g, 1e-5, 1e-3, f"bucket_sums tau {tau}")
        # the export credit is the difference of two sell-weighted sums:
        # held at rtol 1e-5 of those sums
        gap = np.abs(ts_[2].numpy() - np.asarray(js[2]))
        assert np.all(gap <= 1e-5 * np.abs(np.asarray(ref[1])) + 1e-3), gap.max()
        close(jbp.bills_from_sums(*js, w["jat"], p, tau),
              tbk.bills_from_sums(*ts_, w["tat"], p, tau), 1e-5, 1e-3)
        jb2 = (w["jbucket"] + 1) % b
        tb2 = ((w["tbucket"] + 1) % b).to(torch.int32)
        ref = jbp.import_sums_pair(w["load"], w["gen"], w["jsell"], w["jbucket"], w["ts"],
                                   jb2, sc, b, impl="xla", soft_tau=tau)
        got = tbk.import_sums_pair(w["tload"], w["tgen"], w["tsell"], w["tbucket"],
                                   w["tts"], tb2, t(sc), b, impl="plain", soft_tau=tau)
        for r, g in zip(ref, got):
            close(r, g, 1e-5, 1e-3, f"import_sums_pair tau {tau}")
    # the hourly bill, soft, against JAX's
    net_j = w["load"] - sc[:, :1] * w["gen"]
    ref = jax.vmap(lambda l, tt, s: jbill.annual_bill(l, tt, s, p, TAU))(
        net_j, w["jat"], w["ts"])
    close(ref, tbill.annual_bill(t(net_j), w["tat"], w["tts"], p, TAU), 1e-5, 1e-2)
    # the plain engine, hard: the month kernel's plain version's sums
    plain = tbk.import_sums(*targs, impl="plain")
    month = tbk.import_sums(*targs)
    for a, m in zip(plain, month):
        close(m, a, 1e-5, 1e-3, "plain engine")
    # and the soft sums carry a gradient to the scales
    s = t(sc).requires_grad_(True)
    imp, imp_sell = tbk.import_sums(*targs[:4], s, b, soft_tau=TAU)
    (g,) = torch.autograd.grad(imp.sum() + imp_sell.sum(), s)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_soft_payback_and_interpolated_market_share_match_reference():
    rng = np.random.default_rng(5)
    cf = rng.normal(0.0, 1000.0, (64, 26)).astype(np.float32)
    cf[:, 0] = -np.abs(cf[:, 0]) * 10.0
    cf[:8] = np.abs(cf[:8])          # positive from year 0
    cf[8:12, 1:] = -1.0              # never pays back
    for soft in (False, True):
        ref = jax.jit(jax.vmap(functools.partial(jcf.payback_period, soft=soft)))(
            jnp.asarray(cf))
        got = tcf.payback_period(t(cf), soft=soft)
        close(ref, got, 1e-6, 1e-5, f"soft {soft}")
    soft = tcf.payback_period(t(cf), soft=True)
    assert not torch.equal(soft, torch.round(soft * 10.0) / 10.0)

    table = np.sort(rng.uniform(0, 1, (3, 302)), axis=1)[:, ::-1].astype(np.float32).copy()
    pb = rng.uniform(-1.0, 35.0, 64).astype(np.float32)
    sector = rng.integers(0, 3, 64).astype(np.int32)
    for interp in (False, True):
        mms = jax.jit(functools.partial(jmarket.max_market_share, interp=interp))
        close(mms(jnp.asarray(pb), jnp.asarray(sector), jnp.asarray(table)),
              tmarket.max_market_share(t(pb), t(sector), t(table), interp=interp),
              1e-6, 1e-7, f"interp {interp}")
    jg = jax.jit(jax.grad(lambda v: jmarket.max_market_share(
        v, jnp.asarray(sector), jnp.asarray(table), interp=True).sum()))(jnp.asarray(pb))
    close(jg, tgrad(lambda v: tmarket.max_market_share(v, t(sector), t(table),
                                                       interp=True), pb), 1e-5, 1e-5)



def test_soft_mode_refusals_match_reference(bill_world):
    """The stream and dot engines, daylight layouts, packed streams and
    int8 codes refuse ``soft_tau`` in both packages."""
    w = bill_world
    b = 12 * w["p"]
    sc = jnp.asarray(w["scales"])
    jargs = (w["load"], w["gen"], w["jsell"], w["jbucket"], sc, b)
    targs = (w["tload"], w["tgen"], w["tsell"], w["tbucket"], t(sc), b)
    with pytest.raises(ValueError, match="soft_tau requires impl"):
        jbp.import_sums(*jargs, impl="pallas_dot", soft_tau=TAU)
    for impl in ("stream", "dot"):
        with pytest.raises(ValueError, match="soft_tau requires impl"):
            tbk.import_sums(*targs, impl=impl, soft_tau=TAU)
    lay_j = jbp.daylight_layout(w["bank"])
    lay_t = tlay.daylight_layout(w["bank"])
    with pytest.raises(ValueError, match="incompatible with daylight"):
        jbp.import_sums(*jargs, impl="xla", layout=lay_j, soft_tau=TAU)
    with pytest.raises(ValueError, match="incompatible with daylight"):
        tbk.import_sums(*targs, layout=lay_t, soft_tau=TAU)
    packed = tbk.pack_streams(w["tload"], w["tgen"], w["tsell"], w["tbucket"], b)
    with pytest.raises(ValueError, match="incompatible with daylight"):
        tbk.bucket_sums(None, w["tgen"], None, None, t(sc), b, packed=packed,
                        soft_tau=TAU)
    codes = w["tload"].to(torch.int8)
    with pytest.raises(ValueError, match="dequantize"):
        tbk.import_sums(codes, codes, *targs[2:], soft_tau=TAU,
                        load_scale=torch.ones(codes.shape[0]),
                        gen_scale=torch.ones(codes.shape[0]))
    tenv, meta = _world_envs(8, 7, TAU, "cpu")
    ones = torch.ones(tenv.load.shape[0])
    for kw in (dict(daylight=lay_t), dict(pack_once=True)):
        with pytest.raises(ValueError, match="soft_tau requires plain f32"):
            tsizing.size_agents(tenv, meta["n_periods"], meta["n_years"],
                                soft_tau=TAU, **kw)
    with pytest.raises(ValueError, match="soft_tau requires plain f32"):
        tsizing.size_agents(dataclasses.replace(tenv, load_scale=ones, gen_scale=ones),
                            meta["n_periods"], meta["n_years"], soft_tau=TAU)


def _make_env(seed, tariff_k, load_kwh):
    """tests/test_sizing.py's one-agent world (``_make_env``) in the port,
    its financing ``FinanceParams.example()``'s."""
    pop = tsynth.generate_population(8, states=["DE"], seed=seed, pad_multiple=8,
                                     device="cpu")
    ex = jcf.FinanceParams.example()
    fin = tcf.FinanceParams(**{
        f.name: t(np.asarray(getattr(ex, f.name)).reshape(1))
        for f in dataclasses.fields(tcf.FinanceParams) if f.name != "deprec_sch"})
    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    return tsizing.AgentEconInputs(
        load=pop.profiles.load[0][None] * load_kwh,
        gen_per_kw=pop.profiles.solar_cf[4][None],
        ts_sell=torch.full((1, 8760), 0.04),
        tariff=tbill.gather_tariff(pop.tariffs, torch.tensor([tariff_k])), tariff_w=None,
        fin=fin, inc=tcf.IncentiveParams.zeros(1, "cpu"),
        load_kwh_per_customer=one(load_kwh), elec_price_escalator=one(0.005),
        pv_degradation=one(0.005), system_capex_per_kw=one(2500.0),
        system_capex_per_kw_combined=one(2600.0), batt_capex_per_kwh_combined=one(800.0),
        cap_cost_multiplier=one(1.0), value_of_resiliency_usd=one(0.0),
        one_time_charge=one(0.0)), pop.tariffs.max_periods


@pytest.mark.slow
def test_fast_path_matches_slow_path():
    """The port's fast path against its own per-agent oracle on
    tests/test_sizing.py::test_fast_path_matches_slow_path's four agents,
    at that test's tolerances."""
    envs = [_make_env(10 + i, i % 4, 5000.0 + 3000.0 * i) for i in range(4)]
    batched = tree_map(lambda *xs: torch.cat(xs), *(e for e, _ in envs))
    p = envs[0][1]
    rf = tsizing.size_agents(batched, n_periods=p, n_years=25, fast=True)
    rs = tsizing.size_agents(batched, n_periods=p, n_years=25, fast=False)
    # kW* tolerance covers the fast path's grid discretization
    close(rs.system_kw, rf.system_kw, 6e-3, 0.0)
    close(rs.npv, rf.npv, 2e-3, 10.0)
    close(rs.payback_period, rf.payback_period, 0.0, 0.21)
    close(rs.first_year_bill_with_system, rf.first_year_bill_with_system, 1e-3, 1.0)
    close(rs.first_year_bill_with_batt, rf.first_year_bill_with_batt, 1e-3, 1.0)
