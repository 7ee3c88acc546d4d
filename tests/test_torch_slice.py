"""The whole slice: ``Simulation.run`` of the PyTorch port against the JAX
package's on the same seeded world — 48 agents, storage on, the
state-hourly aggregate on, 2 model years, with and without a DG-rate
switch, a NEM cap that closes in year 2 and a non-zero battery
attachment rate; each on the default path and on the gated one
(daylight-compacted lanes, pack-once, the stream engine), and on the
narrow banks: int8 banks with pack-once and the stream engine with a
switch (the configuration of
tests/test_golden_e2e.py::test_golden_quant_banks_within_tolerance), and
bf16 banks without a switch. National curves within rtol 1e-3 (the
golden contract, tests/test_golden_e2e.py), state-hourly net load within
rtol 1e-3 / atol 1e-3 MW, integer battery adopters equal per agent.

Under bf16 banks the per-agent fields and the state-hourly load are held
to one bfloat16 unit (2^-7 relative) instead of 1e-3, and an agent's
payback to one 0.1-year grid step: the JAX package runs under XLA's
default excess precision, which may keep a bfloat16 product (a gathered
load times its multiplier, say) in float32 inside a fused computation,
where the port rounds it to bfloat16 as written. Some hours then differ
by one bfloat16 unit, and a payback on the edge of a grid step may move
to the next one, and the fields read from it (market shares) with it.
The national curves keep rtol 1e-3."""

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation as TSimulation

N = 48
STATES = ["TX", "CA"]


def _overrides(n_groups: int, n_states: int) -> dict:
    caps = np.full((2, n_states), 1e30, np.float32)
    caps[1:] = 2e3     # closes for any state past 2 MW after year 1
    return {
        "attachment_rate": np.full(n_groups, 0.3, np.float32),
        "nem_cap_kw": caps,
    }


GATED = dict(daylight_compact=True, pack_once=True, stream_segments=True)
#: one bfloat16 unit: the bf16 banks' per-agent and state-hourly rtol
BF16_UNIT = 2.0 ** -7
KNOBS = {
    "default": {},
    "gated": GATED,
    "bf16": dict(bf16_banks=True),
    "quant": dict(quant_banks=True, pack_once=True, stream_segments=True),
}


@pytest.fixture(scope="module",
                params=[(0.0, "default"), (0.4, "default"), (0.0, "gated"),
                        (0.4, "gated"), (0.4, "quant")],
                ids=["no_switch", "rate_switch", "no_switch-gated", "rate_switch-gated",
                     "rate_switch-quant"])
def runs(request):
    return _run_both(*request.param)


@pytest.fixture(scope="module")
def bf16_runs():
    return _run_both(0.0, "bf16")


def _run_both(switch: float, name: str):
    knobs = KNOBS[name]
    gated = name == "gated"
    kw = dict(states=STATES, seed=21, pad_multiple=16, rate_switch_frac=switch)
    jp = jsynth.generate_population(N, **kw)
    tp = tsynth.generate_population(N, device="cpu", **kw)
    g, s = jp.table.n_groups, jp.table.n_states
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
    cfg_t = tcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
    jin = jscen.uniform_inputs(cfg_j, n_groups=g, n_regions=jp.n_regions,
                               overrides=_overrides(g, s))
    tin = tscen.uniform_inputs(cfg_t, n_groups=g, n_regions=tp.n_regions,
                               overrides=_overrides(g, s), device="cpu")
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs, jin, cfg_j,
                       jcfg.RunConfig(sizing_iters=4, **knobs), with_hourly=True)
    tsim = TSimulation(tp.table, tp.profiles, tp.tariffs, tin, cfg_t,
                       tcfg.RunConfig(sizing_iters=4, **knobs), with_hourly=True,
                       device="cpu")
    assert (jsim._rate_switch, jsim._net_billing) == \
        (tsim._rate_switch, tsim._net_billing) == (switch > 0, True)
    assert (jsim._daylight is None) == (tsim._daylight is None) == (not gated)
    if gated:
        assert tsim.step_kwargs(True)["sizing_impl"] == "stream"
        assert tsim._daylight.seg_lens == jsim._daylight.seg_lens
    want = {"bf16": torch.bfloat16, "quant": torch.int8}.get(name, torch.float32)
    assert tsim.profiles.load.dtype == want
    return jsim, jsim.run(), tsim, tsim.run()


def test_national_curves_match(runs):
    jsim, jres, tsim, tres = runs
    mask = np.asarray(jsim.host_mask)
    np.testing.assert_array_equal(mask, tsim.host_mask)
    assert list(jres.years) == list(tres.years) == [2014, 2016]
    js, ts = jres.summary(mask), tres.summary(mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    assert js["adopters"][-1] > 0 and js["batt_kwh_cum"][-1] > 0


def test_state_hourly_net_load_matches(runs):
    _, jres, _, tres = runs
    assert tres.state_hourly_net_mw.shape == jres.state_hourly_net_mw.shape
    np.testing.assert_allclose(tres.state_hourly_net_mw, jres.state_hourly_net_mw,
                               rtol=1e-3, atol=1e-3)


def test_battery_adopters_equal_per_agent(runs):
    _, jres, _, tres = runs
    np.testing.assert_array_equal(tres.agent["new_batt_adopters"],
                                  jres.agent["new_batt_adopters"])
    assert tres.agent["new_batt_adopters"].sum() > 0


def test_every_output_field_agrees(runs):
    """Every YearOutputs field, per agent, at the national-curve bound
    plus a float32 atol on the flow scale of each field."""
    _, jres, _, tres = runs
    assert set(tres.agent) == set(jres.agent)
    for k, ref in jres.agent.items():
        got = tres.agent[k]
        assert got.shape == ref.shape, k
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale, err_msg=k)


def test_bf16_national_curves_match(bf16_runs):
    test_national_curves_match(bf16_runs)


def test_bf16_state_hourly_and_battery_adopters_match(bf16_runs):
    _, jres, _, tres = bf16_runs
    np.testing.assert_allclose(tres.state_hourly_net_mw, jres.state_hourly_net_mw,
                               rtol=BF16_UNIT, atol=1e-3)
    test_battery_adopters_equal_per_agent(bf16_runs)


def test_bf16_every_output_field_agrees(bf16_runs):
    """Payback within one grid step for every agent; every field within
    one bfloat16 unit for the agents whose payback agrees (at least 90%
    of them); bf16 banks in both packages."""
    jsim, jres, tsim, tres = bf16_runs
    assert tsim.profiles.load.dtype == torch.bfloat16
    assert str(jsim.profiles.load.dtype) == "bfloat16"
    pay_t, pay_j = tres.agent["payback_period"], jres.agent["payback_period"]
    assert np.all(np.abs(pay_t - pay_j) <= 0.1 + 1e-4)
    same = np.all(np.abs(pay_t - pay_j) < 1e-4, axis=0)
    assert same.mean() >= 0.9, same.mean()
    for k, ref in jres.agent.items():
        got = tres.agent[k]
        assert got.shape == ref.shape, k
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got[:, same], ref[:, same], rtol=BF16_UNIT,
                                   atol=1e-4 * scale, err_msg=k)
