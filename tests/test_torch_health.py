"""The numerical-health sentinel and the invariant harness of the PyTorch
port.

The port's ``health_summary`` / ``check_host`` against the JAX package's,
count for count, on the same ``YearOutputs`` made from numpy with a seed,
clean and with NaN / inf / 1e30 poison in chosen rows (padding rows
never count); ``breach_error`` naming the poisoned agents' ids;
``Simulation.run`` warning on a breach by default and raising
``HealthBreachError`` under ``sentinel_escalate``; and the invariant
checks catching a changed shape, a changed dtype and a NaN, also from
``run`` under ``debug_invariants``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu.models import health as jhealth
from dgen_tpu.models.simulation import YearOutputs as JYearOutputs
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import health as thealth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import SimCarry, Simulation, YearOutputs
from dgen_tpu_torch.utils.invariants import (
    InvariantViolation,
    check_finite,
    check_transform,
    nonfinite_rows,
)

N = 40
#: leading shape of each field beyond the agent axis
WIDE = {"cash_flow": (26,), "energy_value_pv_only": (25,)}


def _outputs(seed: int = 0) -> dict:
    """Every YearOutputs field as a numpy array of plausible values."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in dataclasses.fields(YearOutputs):
        if f.name == "state_hourly_net_mw":
            out[f.name] = rng.random((3, 8760), dtype=np.float32)
        else:
            out[f.name] = rng.random((N,) + WIDE.get(f.name, ()), dtype=np.float32)
    return out


def _both(arrays: dict, mask: np.ndarray):
    t = YearOutputs(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    j = JYearOutputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return (t, torch.from_numpy(mask)), (j, jnp.asarray(mask))


MASK = np.ones(N, np.float32)
MASK[-4:] = 0.0
#: (leaf, row, column or None, value): the poisons of the breached case
POISON = [("npv", 3, None, np.nan), ("payback_period", 7, None, 1e30),
          ("cash_flow", 11, 5, np.inf), ("market_share", 20, None, -5.0),
          ("system_kw", N - 2, None, np.nan)]      # a padding row: never counts


def _poisoned() -> dict:
    a = _outputs()
    for leaf, row, col, v in POISON:
        if col is None:
            a[leaf][row] = v
        else:
            a[leaf][row, col] = v
    return a


@pytest.mark.parametrize("case", ["clean", "poisoned"])
def test_summary_and_verdict_equal_the_jax_package(case):
    arrays = _outputs() if case == "clean" else _poisoned()
    (t, tm), (j, jm) = _both(arrays, MASK)
    ts = thealth.health_summary(t, tm)
    js = np.asarray(jhealth.health_summary(j, jm))
    assert ts.dtype == torch.int32 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(ts.numpy(), js)
    assert thealth.check_host(ts) == jhealth.check_host(js)
    assert [n for n, _, _ in thealth.HEALTH_CHECKS] == \
        [n for n, _, _ in jhealth.HEALTH_CHECKS]
    if case == "clean":
        assert thealth.check_host(ts) == []
    else:
        leaves = {b["leaf"] for b in thealth.check_host(ts)}
        assert leaves == {"npv", "payback_period", "cash_flow", "market_share"}


def test_breach_error_names_the_poisoned_agents():
    arrays = _poisoned()
    (t, tm), (j, _) = _both(arrays, MASK)
    ids = np.arange(1000, 1000 + N)
    breaches = thealth.check_host(thealth.health_summary(t, tm))
    err = thealth.breach_error(2016, 1, breaches, t, ids, MASK)
    jerr = jhealth.breach_error(2016, 1, breaches, j, ids, MASK)
    # per-agent leaves attribute first: the market-share row is not named
    assert err.agent_rows == jerr.agent_rows == (3, 7, 11)
    assert err.agent_ids == (1003, 1007, 1011)
    assert str(err) == str(jerr)
    assert isinstance(err, thealth.HealthBreachError) and err.year == 2016
    # unattributed without the outputs
    assert thealth.breach_error(2016, 1, breaches, None, ids, MASK).agent_ids == ()
    # only a market-step leaf breached: it attributes
    only_ms = [b for b in breaches if b["leaf"] == "market_share"]
    assert thealth.breach_error(2016, 1, only_ms, t, ids, MASK).agent_rows == (20,)


def _sim(**rc) -> Simulation:
    pop = tsynth.generate_population(24, states=["TX"], seed=5, pad_multiple=8,
                                     device="cpu")
    cfg = tcfg.ScenarioConfig(start_year=2014, end_year=2014, anchor_years=())
    inputs = tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions, device="cpu")
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      tcfg.RunConfig(sizing_iters=4, **rc), device="cpu")


def _poison_step(sim, rows=(2, 5)):
    step = sim.step

    def poisoned(carry, yi, first_year):
        carry, outs = step(carry, yi, first_year)
        npv = outs.npv.clone()
        npv[list(rows)] = float("nan")
        return carry, dataclasses.replace(outs, npv=npv)

    sim.step = poisoned


def test_run_warns_on_a_breach_by_default_and_raises_under_escalation(caplog):
    sim = _sim()
    res = sim.run(collect=False)
    assert res.agent == {} and sim.health_report == {"breaches": {}, "clean": True}
    _poison_step(sim)
    with caplog.at_level("WARNING"):
        sim.run(collect=False)
    assert not sim.health_report["clean"]
    assert sim.health_report["breaches"][2014][0]["leaf"] == "npv"
    assert "health sentinel" in caplog.text
    esc = _sim(sentinel_escalate=True)
    _poison_step(esc)
    with pytest.raises(thealth.HealthBreachError) as ei:
        esc.run()
    assert ei.value.agent_ids == tuple(int(esc.host_agent_id[r]) for r in (2, 5))
    off = _sim(health_sentinel=False, sentinel_escalate=True)
    _poison_step(off)
    off.run(collect=False)
    assert off.health_report is None


def test_run_calls_back_every_year_with_the_device_outputs():
    sim = _sim()
    seen = []
    res = sim.run(callback=lambda y, yi, outs: seen.append((y, yi, outs.npv.shape[0])),
                  collect=False)
    assert seen == [(2014, 0, sim.table.n_agents)]
    assert res.years == [2014] and res.agent == {} and res.state_hourly_net_mw is None


def test_invariants_catch_shape_dtype_and_nan():
    carry = SimCarry.zeros(8, "cpu")
    check_transform(carry, SimCarry.zeros(8, "cpu"), context="clean")
    check_finite(carry, context="clean")
    grown = dataclasses.replace(carry, batt_adopters_cum=torch.zeros(16))
    with pytest.raises(InvariantViolation, match="shape of .batt_adopters_cum"):
        check_transform(carry, grown)
    drifted = dataclasses.replace(carry, batt_adopters_cum=torch.zeros(8, dtype=torch.float64))
    with pytest.raises(InvariantViolation, match="dtype"):
        check_transform(carry, drifted)
    share = torch.zeros(8)
    share[[1, 6]] = float("nan")
    bad = dataclasses.replace(carry, market=dataclasses.replace(carry.market,
                                                                market_share=share))
    with pytest.raises(InvariantViolation, match=r"2 non-finite values in "
                       r"\.market\.market_share .*\[1, 6\]"):
        check_finite(bad, context="year 2016")
    check_finite(bad, allow_nonfinite=("market_share",))
    np.testing.assert_array_equal(nonfinite_rows(share), [1, 6])


def test_debug_invariants_run_checks_every_year():
    sim = _sim(debug_invariants=True)
    sim.run()
    step = sim.step

    def nan_carry(carry, yi, first_year):
        carry, outs = step(carry, yi, first_year)
        kw = carry.market.system_kw_cum.clone()
        kw[0] = float("nan")
        return dataclasses.replace(carry, market=dataclasses.replace(
            carry.market, system_kw_cum=kw)), outs

    sim.step = nan_carry
    with pytest.raises(InvariantViolation, match="year 2014 carry"):
        sim.run()
