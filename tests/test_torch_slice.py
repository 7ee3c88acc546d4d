"""The whole slice: ``Simulation.run`` of the PyTorch port against the JAX
package's on the same seeded world — 48 agents, storage on, the
state-hourly aggregate on, 2 model years, with and without a DG-rate
switch, a NEM cap that closes in year 2 and a non-zero battery
attachment rate; each on the default path and on the gated one
(daylight-compacted lanes, pack-once, the stream engine). National
curves within rtol 1e-3 (the golden contract, tests/test_golden_e2e.py),
state-hourly net load within rtol 1e-3 / atol 1e-3 MW, integer battery
adopters equal per agent."""

import numpy as np
import pytest

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


@pytest.fixture(scope="module",
                params=[(0.0, False), (0.4, False), (0.0, True), (0.4, True)],
                ids=["no_switch", "rate_switch", "no_switch-gated", "rate_switch-gated"])
def runs(request):
    switch, gated = request.param
    knobs = GATED if gated else {}
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
