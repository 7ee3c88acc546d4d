"""Golden fixture #2 on the PyTorch port: the binding-NEM-cap flip of
tests/test_golden_capflip.py, rebuilt on the port's synthetic population
and scenario inputs (which reproduce the JAX package's byte for byte) and
run on the CPU with the plain versions.

A 192-agent population over DE, CA and TX with half its agents on a DG
rate switch, storage on and the default anchor years runs uncapped once;
the state NEM caps are then set to 30% of each populated state's final
capacity, so they bind mid-run and agents flip from net metering to net
billing. The run is held to tests/fixtures/golden_capflip.json under the
JAX test's contract: the per-year NEM-eligible counts exact (through the
port's own ``_nem_allowed_arrays``), the curves within rtol 1e-3 and the
state-hourly net MWh within rtol 1e-3, atol 0.05."""

import json
import os

import numpy as np
import pytest

from dgen_tpu_torch.config import RunConfig, ScenarioConfig
from dgen_tpu_torch.io import synth
from dgen_tpu_torch.models import scenario as scen
from dgen_tpu_torch.models.simulation import Simulation, _nem_allowed_arrays

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "golden_capflip.json")
RTOL = 1e-3

pytestmark = pytest.mark.slow

CAP_FRACTION = 0.30   # caps at 30% of the uncapped final state capacity


def _build(caps=None):
    cfg = ScenarioConfig(name="capflip", start_year=2014, end_year=2050,
                         storage_enabled=True)
    pop = synth.generate_population(192, states=["DE", "CA", "TX"], seed=11,
                                    pad_multiple=32, rate_switch_frac=0.5,
                                    device="cpu")
    overrides = {"attachment_rate": np.full((pop.table.n_groups,), 0.35, np.float32)}
    if caps is not None:
        overrides["nem_cap_kw"] = np.tile(np.asarray(caps, np.float32),
                                          (len(cfg.model_years), 1))
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, overrides=overrides,
                                 device="cpu")
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                     RunConfig(sizing_iters=8), with_hourly=True, device="cpu")
    return sim, pop, inputs


def _state_kw_by_year(res, pop):
    """[n_years, n_states] cumulative installed kW of the real agents."""
    kw = res.agent["system_kw_cum"] * pop.table.mask.numpy()[None, :]
    st = pop.table.state_idx.numpy()
    out = np.zeros((kw.shape[0], pop.table.n_states), np.float64)
    for yi in range(kw.shape[0]):
        np.add.at(out[yi], st, kw[yi])
    return out


def _nem_allowed_per_year(pop, inputs, res):
    """Per-year count of NEM-eligible real agents, through the driver's
    own predicate with the cap gate fed last year's installed capacity."""
    t = pop.table
    mask = t.mask.numpy() > 0
    state_kw = _state_kw_by_year(res, pop)
    years = inputs.years.numpy()
    caps = inputs.nem_cap_kw.numpy()
    counts = []
    for yi, yr in enumerate(years):
        last = (np.zeros(t.n_states, np.float32) if yi == 0
                else state_kw[yi - 1].astype(np.float32))
        allowed = _nem_allowed_arrays(
            t.state_idx.numpy(), t.nem_first_year.numpy(), t.nem_sunset_year.numpy(),
            t.nem_kw_limit.numpy(), caps[yi], np.float32(yr), last)
        counts.append(int((allowed & mask).sum()))
    return counts


@pytest.fixture(scope="module")
def capflip_run():
    sim0, pop, _ = _build()
    res0 = sim0.run()
    final_state_kw = _state_kw_by_year(res0, pop)[-1]
    populated = np.zeros(pop.table.n_states, bool)
    populated[np.unique(pop.table.state_idx.numpy()[pop.table.mask.numpy() > 0])] = True
    assert (final_state_kw[populated] > 0).all(), (
        "uncapped pre-run must adopt in every populated state")
    caps = np.where(populated, final_state_kw * CAP_FRACTION, 1e30)

    sim, pop, inputs = _build(caps=caps)
    assert sim._net_billing, "finite caps must defeat the nem_gate_never_closes proof"
    return pop, inputs, sim.run()


def test_capflip_flips_mid_run(capflip_run):
    pop, inputs, res = capflip_run
    counts = _nem_allowed_per_year(pop, inputs, res)
    assert counts[0] > 0
    assert min(counts) < counts[0], (
        f"NEM-allowed counts never decreased ({counts}); the fixture's caps no "
        "longer bind mid-run")
    flip_year_idx = next(i for i in range(1, len(counts)) if counts[i] < counts[i - 1])
    assert flip_year_idx >= 1
    m = pop.table.mask.numpy()
    adopters = (res.agent["number_of_adopters"] * m[None, :]).sum(axis=1)
    assert adopters[-1] > adopters[flip_year_idx]


def test_capflip_golden_curves(capflip_run):
    pop, inputs, res = capflip_run
    m = pop.table.mask.numpy()
    ids = pop.table.agent_id.numpy()
    s = res.summary(m)
    curves = {
        "years": list(map(int, res.years)),
        "nem_allowed": _nem_allowed_per_year(pop, inputs, res),
        "adopters": s["adopters"],
        "system_kw_cum": s["system_kw_cum"],
        "batt_kwh_cum": s["batt_kwh_cum"],
        "cash_flow_total": [float((cf * m[:, None]).sum()) for cf in res.agent["cash_flow"]],
        "adoption_checksum": float((res.agent["number_of_adopters"][-1] * m
                                    * (ids % 97 + 1)).sum()),
        "state_hourly_net_mwh": res.state_hourly_net_mw.sum(axis=2),
    }
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert curves["years"] == golden["years"]
    assert curves["nem_allowed"] == golden["nem_allowed"], (
        "the NEM gate's per-year eligibility counts changed")
    for key in ("adopters", "system_kw_cum", "batt_kwh_cum", "cash_flow_total",
                "adoption_checksum"):
        np.testing.assert_allclose(
            curves[key], golden[key], rtol=RTOL,
            err_msg=f"{key} drifted >0.1% from the capflip golden curve")
    np.testing.assert_allclose(curves["state_hourly_net_mwh"],
                               golden["state_hourly_net_mwh"], rtol=RTOL, atol=0.05)
