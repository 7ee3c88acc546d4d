"""The analysis side of the PyTorch port against the JAX package on the
CPU: the demand-charge engine (``ops/demand.py``), the demand-charge
audit on tests/test_demand.py's 48-agent world, the dispatch
diagnostics and their roll-up, and the multi-technology diffusion step
(``diffusion_step_tech_choice``) in a first and a later year. Also the
guards and switches around the differentiable twin: the kernel wrappers'
refusal to drop a gradient, ``RunConfig``'s soft switches and ``seed``
against JAX's, and a 64-agent soft run of five years.

Tolerances: demand charges rtol 1e-5 (maxima are exact; the tier prices
and the sum over months add float32 terms in another order), the audit
rtol 1e-5 / atol 1e-3 (its battery run is the same float32 recursion);
diagnostics rtol 1e-5 / atol 1e-3 on the kWh and $ sums, counts exact;
the diffusion outputs at tests/test_market.py's rtol 2e-5, atol 1e-6
(shares) and 1e-3 (adopters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dgen_tpu import analysis as janalysis
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import market as jmarket
from dgen_tpu.ops import demand as jdemand
from dgen_tpu.ops import dispatch as jdisp
from dgen_tpu_torch import analysis as tanalysis
from dgen_tpu_torch import convert
from dgen_tpu_torch.config import RunConfig
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import market as tmarket
from dgen_tpu_torch.ops import billkernels as tbk
from dgen_tpu_torch.ops import demand as tdemand
from dgen_tpu_torch.ops import dispatch as tdisp

HOURS = 8760


def t(x):
    return torch.from_numpy(np.array(x))


def close(ref, got, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def _loads(n, seed):
    rng = np.random.default_rng(seed)
    hod = np.arange(HOURS) % 24
    base = 5.0 + 10.0 * np.exp(-0.5 * ((hod - 18) / 3.0) ** 2)
    load = base[None, :] * (0.7 + 0.6 * rng.random((n, HOURS)))
    # some net exports (negative net load) floor at 0
    load[:, ::97] -= 30.0
    return load.astype(np.float32)


SPECS = [
    # two-tier seasonal flat charge with a finite first cap
    {"d_flat_prices": [[8.0] * 6 + [10.0] * 6, [12.0] * 12],
     "d_flat_levels": [[12.0] * 12, [1e9] * 12]},
    # TOU windows from 12x24 schedules, two tiers per window
    {"d_tou_prices": [[2.0, 11.0], [3.0, 15.0]],
     "d_tou_levels": [[6.0, 9.0], [1e9, 1e9]],
     "d_wkday_12by24": [[0] * 16 + [1] * 5 + [0] * 3] * 12,
     "d_wkend_12by24": [[0] * 24] * 12},
    None,
    # flat and TOU together, a finite top cap
    {"d_flat_prices": [[5.0] * 12], "d_flat_levels": [[50.0] * 12],
     "d_tou_prices": [[4.0, 9.0]], "d_tou_levels": [[1e9, 1e9]],
     "d_wkday_12by24": [[0] * 12 + [1] * 8 + [0] * 4] * 12},
]


def test_demand_bank_and_charges_match_reference():
    """The compiled bank leaf for leaf, the monthly peaks and the annual
    charges of every tariff against JAX's on the same net loads; the
    converter carries JAX's bank across unchanged."""
    jbank = jdemand.compile_demand_bank(SPECS)
    tbank = tdemand.compile_demand_bank(SPECS, device="cpu")
    for name in jdemand.DemandTariff._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jbank, name)),
                                      getattr(tbank, name).numpy(), err_msg=name)
    carried = convert.demand_tariff(
        {k: np.asarray(v) for k, v in jbank._asdict().items()}, device="cpu")
    for a, b in zip(carried, tbank):
        assert torch.equal(a, b)
    assert convert.to_numpy_dict(tbank).keys() == jbank._asdict().keys()

    n = 12
    loads = _loads(n, 3)
    tidx = np.arange(n) % len(SPECS)
    jat = jax.tree.map(lambda x: x[tidx], jbank)
    tat = tdemand.DemandTariff(*(x[torch.from_numpy(tidx)] for x in tbank))
    ref = jax.vmap(jdemand.annual_demand_charge)(jnp.asarray(loads), jat)
    got = tdemand.annual_demand_charge(t(loads), tat)
    close(ref, got, 1e-5, 1e-3)
    assert got[tidx == 2].abs().max() == 0.0
    n_w = tbank.tou_price.shape[-2]
    jf, jt = jax.vmap(lambda l, w: jdemand.monthly_peaks(l, w, n_w))(
        jnp.asarray(loads), jat.hour_window)
    tf, tt = tdemand.monthly_peaks(t(loads), tat.hour_window, n_w)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    # one tariff compiled alone prices as it does inside the bank
    alone = tdemand.compile_demand_tariff(**SPECS[0], device="cpu")
    one = tdemand.annual_demand_charge(
        t(loads[:1]), tdemand.DemandTariff(*(x[None] for x in alone)))
    close(got[:1], one, 1e-6, 0.0)
    assert tdemand.compile_demand_bank([None, {}], device="cpu") is None
    with pytest.raises(ValueError, match="window ids"):
        tdemand.compile_demand_tariff(d_tou_prices=[[1.0]],
                                      d_tou_8760=np.ones(HOURS), device="cpu")


@pytest.fixture(scope="module")
def audit_world():
    """tests/test_demand.py:169-200's world in both packages: 48 agents in
    DE, a flat demand charge on every tariff spec, 4 kW systems and
    2 kW / 4 kWh batteries."""
    jp = jsynth.generate_population(48, states=["DE"], seed=5, pad_multiple=16)
    tp = tsynth.generate_population(48, states=["DE"], seed=5, pad_multiple=16,
                                    device="cpu")
    specs = [dict(s) for s in tsynth.make_tariff_specs()]
    for s in specs:
        s["demand"] = {"d_flat_prices": [[5.0] * 12], "d_flat_levels": [[1e9] * 12]}
    n = tp.table.n_agents
    sizes = dict(load=12000.0, kw=4.0, bkw=2.0, bkwh=4.0)
    ref = janalysis.demand_charge_audit(
        jp.table, jp.profiles, specs, jnp.full(n, sizes["load"]),
        system_kw=jnp.full(n, sizes["kw"]), batt_kw=jnp.full(n, sizes["bkw"]),
        batt_kwh=jnp.full(n, sizes["bkwh"]))
    got = tanalysis.demand_charge_audit(
        tp.table, tp.profiles, specs, torch.full((n,), sizes["load"]),
        system_kw=torch.full((n,), sizes["kw"]), batt_kw=torch.full((n,), sizes["bkw"]),
        batt_kwh=torch.full((n,), sizes["bkwh"]))
    return tp, specs, ref, got


def test_demand_charge_audit_matches_reference(audit_world):
    tp, specs, ref, got = audit_world
    assert set(got) == set(ref) == {"baseline", "pv_only", "with_batt"}
    for k in got:
        close(ref[k], got[k], 1e-5, 1e-3, k)


def test_demand_charge_audit_end_to_end(audit_world):
    """tests/test_demand.py::test_demand_charge_audit_end_to_end's
    assertions on the port: finite, masked, priced, baseline >= pv_only,
    one agent priced directly, and None without demand structures."""
    tp, specs, _, out = audit_world
    m = tp.table.mask.numpy()
    for k, v in out.items():
        v = v.numpy()
        assert np.all(np.isfinite(v)), k
        assert np.all(v[m == 0] == 0.0), f"padding priced in {k}"
        assert v[m > 0].min() > 0.0, f"no charges in {k}"
    assert np.all(out["pv_only"].numpy() <= out["baseline"].numpy() + 1e-4)
    i = int(np.nonzero(m)[0][0])
    load_i = tp.profiles.load[int(tp.table.load_idx[i])] * 12000.0
    dt = tdemand.compile_demand_tariff(d_flat_prices=[[5.0] * 12],
                                       d_flat_levels=[[1e9] * 12], device="cpu")
    want = tdemand.annual_demand_charge(load_i[None],
                                        tdemand.DemandTariff(*(x[None] for x in dt)))
    assert float(out["baseline"][i]) == pytest.approx(float(want[0]), rel=1e-5)
    n = tp.table.n_agents
    assert tanalysis.demand_charge_audit(tp.table, tp.profiles,
                                         tsynth.make_tariff_specs(),
                                         torch.full((n,), 12000.0)) is None


def test_dispatch_diagnostics_match_reference():
    """tests/test_demand.py::test_dispatch_diagnostics_invariants' world in
    both packages: every diagnostic against JAX's, the roll-up too, and
    that test's routing identities on the port."""
    rng = np.random.default_rng(4)
    n = 16
    hod = np.arange(HOURS) % 24
    sun = np.clip(np.sin((hod - 6) / 12 * np.pi), 0.0, None)
    load = (rng.uniform(0.5, 2.0, (n, HOURS))
            * (1 + 0.3 * (hod >= 17)[None, :])).astype(np.float32)
    gen = (sun[None, :] * rng.uniform(2.0, 8.0, (n, 1))).astype(np.float32)
    sell = np.full((n, HOURS), 0.04, np.float32)
    buy = np.full((n, HOURS), 0.13, np.float32)
    bkw, bkwh, rt = (np.full(n, v, np.float32) for v in (2.5, 5.0, 0.92))
    jdr = jax.jit(jax.vmap(jdisp.dispatch_battery))(*(jnp.asarray(x) for x in
                                                      (load, gen, bkw, bkwh, rt)))
    tdr = tdisp.dispatch_battery(*(t(x) for x in (load, gen, bkw, bkwh, rt)))
    for with_cap in (True, False):
        ref = jax.jit(janalysis.dispatch_diagnostics)(
            jnp.asarray(load), jnp.asarray(gen), jdr, jnp.asarray(sell),
            buy=jnp.asarray(buy), batt_kw=jnp.asarray(bkw) if with_cap else None)
        got = tanalysis.dispatch_diagnostics(t(load), t(gen), tdr, t(sell), buy=t(buy),
                                             batt_kw=t(bkw) if with_cap else None)
        assert set(ref) == set(got)
        for k in ref:
            if "hours" in k:
                np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), k)
            else:
                close(ref[k], got[k], 1e-5, 1e-3, k)
        mask = np.ones(n)
        mask[3] = 0.0
        sr = janalysis.summarize_dispatch(ref, mask)
        sg = tanalysis.summarize_dispatch(got, torch.from_numpy(mask))
        assert set(sr) == set(sg)
        for k in sr:
            assert sg[k] == pytest.approx(sr[k], rel=1e-5, abs=1e-3), k
    d = {k: v.numpy() for k, v in got.items()}
    assert np.all(d["pv_to_batt_total_kwh"] <= d["surplus_total_kwh"] + 1e-3)
    assert np.all((d["capture_mid_frac"] >= 0) & (d["capture_mid_frac"] <= 1 + 1e-6))
    assert d["pv_to_batt_mid_kwh"].sum() > 0
    np.testing.assert_allclose(d["pv_export_revenue_usd"],
                               d["pv_to_grid_total_kwh"] * 0.04, rtol=1e-5)


@pytest.mark.parametrize("first", [True, False], ids=["first_year", "later_year"])
def test_tech_choice_diffusion_matches_reference(first):
    """tests/test_market.py's tech-choice world through both packages;
    nothing in either calls the function, so it is held to JAX's
    directly."""
    rng = np.random.default_rng(7)
    n, k = 48, 3
    msl = rng.uniform(0.0, 0.3, (n, k)).astype(np.float32)
    mms = rng.uniform(0.2, 0.6, (n, k)).astype(np.float32)
    sel = np.zeros((n, k), np.float32)
    sel[np.arange(n), rng.integers(0, k, n)] = 1.0
    kw = rng.uniform(0.0, 10.0, (n, k)).astype(np.float32)
    kw[rng.random((n, k)) < 0.1] = 0.0
    capex = rng.uniform(1000, 4000, (n, k)).astype(np.float32)
    w = rng.uniform(10, 500, n).astype(np.float32)
    p = rng.uniform(0.001, 0.01, (n, k)).astype(np.float32)
    q = rng.uniform(0.3, 0.5, (n, k)).astype(np.float32)
    teq1 = rng.uniform(0.0, 4.0, (n, k)).astype(np.float32)
    adl = rng.uniform(0, 50, (n, k)).astype(np.float32)
    cpl = rng.uniform(0, 500, (n, k)).astype(np.float32)
    mvl = rng.uniform(0, 5e5, (n, k)).astype(np.float32)
    args = (msl, adl, cpl, mvl, sel, mms, kw, capex, w, p, q, teq1)
    ref = jmarket.diffusion_step_tech_choice(*(jnp.asarray(x) for x in args),
                                             is_first_year=first)
    got = tmarket.diffusion_step_tech_choice(*(t(x) for x in args),
                                             is_first_year=first)
    assert set(ref) == set(got)
    for key in ref:
        atol = 1e-3 if key in ("new_adopters", "number_of_adopters") else 1e-6
        if key in ("new_capacity_kw", "installed_capacity_kw"):
            atol = 1e-2
        if key in ("new_market_value", "market_value"):
            atol = 10.0
        close(ref[key], got[key], 2e-5, atol, key)
    assert got["market_share"].sum(dim=1).max() <= 1.0 + 1e-5
    np.testing.assert_allclose(got["market_share"].numpy()[sel == 0], msl[sel == 0],
                               rtol=1e-6)


# guards and switches of the differentiable twin

def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """No kernel drops a gradient silently: the bucket-sums checks and the
    dispatch wrapper raise, naming the kernel, on an input that requires
    grad under grad mode (or carries a forward-mode tangent); under
    ``torch.no_grad`` the same inputs pass the check."""
    n, lanes = 2, 8760
    load = torch.rand(n, lanes)
    scales = torch.rand(n, 3, requires_grad=True)
    period = torch.zeros(n, lanes, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bucket_sums_month: .*no backward"):
        tbk._check_kernel_inputs((load, load, load), (period,), scales, lanes,
                                 kernel="bucket_sums_month")
    with torch.no_grad():
        assert tbk._check_kernel_inputs((load, load, load), (period,), scales,
                                        lanes) == (n, 3)
    kw = torch.ones(n, requires_grad=True)
    with pytest.raises(RuntimeError, match="battery_dispatch.*no backward"):
        tdisp._dispatch_kernel(load, load, kw, kw, torch.ones(n))
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.ones(n), torch.ones(n))
        with pytest.raises(RuntimeError, match="battery_dispatch"):
            tbk.check_no_grad("battery_dispatch", (load, dual))
    tbk.check_no_grad("any", (load, period, None))


def test_run_config_soft_switches_and_seed(monkeypatch):
    """``soft_boundaries``, ``soft_tau`` and ``seed`` as the JAX package's
    RunConfig has them, with its checks, and from the environment."""
    from dgen_tpu.config import RunConfig as JRunConfig

    for knob in ("daylight_compact", "bf16_banks", "quant_banks", "pack_once",
                 "stream_segments", "cluster_tariffs"):
        for cls in (JRunConfig, RunConfig):
            with pytest.raises(ValueError, match="soft_boundaries requires"):
                cls(soft_boundaries=True, **{knob: True})
    for cls in (JRunConfig, RunConfig):
        with pytest.raises(ValueError, match="soft_tau must be > 0"):
            cls(soft_tau=0.0)
        assert cls().soft_tau_static is None and cls().seed == 0
        assert cls(soft_boundaries=True, soft_tau=0.3).soft_tau_static == 0.3
        assert cls(seed=5).seed == 5
    for name in ("DGEN_TPU_SOFT", "DGEN_TPU_SOFT_TAU"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DGEN_TPU_SOFT", "1")
    monkeypatch.setenv("DGEN_TPU_SOFT_TAU", "0.05")
    rc, jrc = RunConfig.from_env(), JRunConfig.from_env()
    assert rc.soft_boundaries is jrc.soft_boundaries is True
    assert rc.soft_tau_static == jrc.soft_tau_static == 0.05


def test_soft_run_of_five_years():
    """tests/test_grad.py::test_soft_mode_steady_state_years_do_not_retrace's
    run on the port (the retrace guard is not ported): 64 agents in DE,
    2014-2022, soft boundaries; the soft year runs through the plain
    differentiable sums and unrounded paybacks. An 8-year cash-flow
    horizon (the CHECK_* one) keeps the plain sums' CPU time down."""
    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.models import scenario
    from dgen_tpu_torch.models.simulation import Simulation

    cfg = ScenarioConfig(name="t", start_year=2014, end_year=2022, anchor_years=())
    pop = tsynth.generate_population(64, states=["DE"], seed=11, pad_multiple=64,
                                     device="cpu")
    inputs = scenario.uniform_inputs(
        cfg, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(pop.table.n_groups, 0.4, np.float32)},
        device="cpu")
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                     RunConfig(sizing_iters=6, soft_boundaries=True, soft_tau=0.1),
                     econ_years=8, device="cpu")
    assert sim.step_kwargs(True)["soft_tau"] == 0.1
    res = sim.run()
    assert len(res.years) == 5
    m = pop.table.mask.numpy() > 0
    for k, v in res.agent.items():
        assert np.all(np.isfinite(v)), k
    pb = res.agent["payback_period"][:, m]
    assert np.any(np.abs(pb * 10.0 - np.round(pb * 10.0)) > 1e-3)
    assert res.summary(sim.host_mask)["adopters"][-1] > 0
