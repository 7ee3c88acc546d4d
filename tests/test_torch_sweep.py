"""The sweep engine of the PyTorch port (``dgen_tpu_torch.sweep``) against
its own single runs and against the JAX package's sweep
(``dgen_tpu.sweep``), on the population of tests/test_sweep.py: 96
agents over DE and CA, seed 11, model years 2014-2016, sizing_iters 6.

Each scenario of a sweep, in vmap mode (the group's rows side by side
in every sizing launch) and in loop mode, equals its own
``Simulation.run`` exactly, per agent; against the JAX package's
``SweepSimulation`` the curves hold at rtol 1e-3 and every field at
rtol 1e-3 / atol 1e-4 x the field's scale (tests/test_torch_slice.py's
tolerances). The planner's groups and modes equal JAX's where the
budget is unknown (the CPU) and its budget error names the budget. The
runs take a 5-year cash-flow horizon (``econ_years=5``, both packages
alike: the plain bucket sums set the CPU's pace and scale with it) and
a tripled retail price, so systems pay back within it and agents adopt.

Not here: the JAX package's retrace tests
(``test_sweep_steady_state_compiles_once_per_group``): PyTorch compiles
nothing to retrace, and the guard is ``ROADMAP.md`` item 12. The sweep on
ranks is tests/test_torch_sweep_ranks.py's.
"""

import dataclasses as dc
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import checkpoint as tckpt
from dgen_tpu_torch.io import export as texport
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation
from dgen_tpu_torch.sweep import (
    MODE_LOOP,
    MODE_VMAP,
    SweepBudgetError,
    SweepSimulation,
    plan_sweep,
)

ECON = 5
POP_KW = dict(states=["DE", "CA"], seed=11, pad_multiple=32)
CFG_KW = dict(name="sweep-t", start_year=2014, end_year=2016, anchor_years=())
TCFG = tcfg.ScenarioConfig(**CFG_KW)
JCFG = jcfg.ScenarioConfig(**CFG_KW)
RC = tcfg.RunConfig(sizing_iters=6)
JRC = jcfg.RunConfig(sizing_iters=6)
Y = len(TCFG.model_years)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tpop():
    return tsynth.generate_population(96, device="cpu", **POP_KW)


@pytest.fixture(scope="module")
def jpop():
    return jsynth.generate_population(96, **POP_KW)


def overrides(pop, itc=0.30, **kw):
    """The scenario's ITC, a tripled retail price (systems pay back
    within the 5-year horizon, so agents adopt) and a battery attachment
    rate of 0.3 (batteries are allocated)."""
    return {"itc_fraction": np.full((Y, 3), itc, np.float32),
            "elec_price_multiplier": np.full((Y, pop.n_regions, 3), 3.0, np.float32),
            "attachment_rate": np.full(pop.table.n_groups, 0.3, np.float32), **kw}


def t_inputs(pop, itc=0.30, **kw):
    return tscen.uniform_inputs(TCFG, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
                                overrides=overrides(pop, itc, **kw), device="cpu")


def j_inputs(pop, itc=0.30, **kw):
    return jscen.uniform_inputs(JCFG, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
                                overrides=overrides(pop, itc, **kw))


def single(pop, inputs, rc=RC, **kw):
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, TCFG, rc,
                      econ_years=ECON, device="cpu", **kw).run()


def sweep_of(pop, members, rc=RC, **kw):
    return SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, TCFG, rc,
                           econ_years=ECON, device="cpu", **kw)


def assert_same_run(got, want, what):
    assert list(got.years) == list(want.years), what
    assert set(got.agent) == set(want.agent), what
    for k, v in want.agent.items():
        np.testing.assert_array_equal(got.agent[k], v, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def itc_runs(tpop, tmp_path_factory):
    """ITC 0.30 and 0.0: each scenario's own Simulation.run, the vmap
    sweep (checkpointed and exporting as it runs) and the loop sweep
    (labelled timers)."""
    from dgen_tpu_torch.utils import timing

    work = tmp_path_factory.mktemp("itc")
    members = [t_inputs(tpop, 0.30), t_inputs(tpop, 0.0)]
    singles = [single(tpop, m) for m in members]
    vmap = sweep_of(tpop, members, labels=["itc30", "itc0"])
    res_v = vmap.run(checkpoint_dir=str(work / "ckpt-vmap"), run_dir=str(work / "live"))
    timing.reset_timings()
    loop = sweep_of(tpop, members, max_vmap_scenarios=1, labels=["hi", "lo"])
    res_l = loop.run(checkpoint_dir=str(work / "ckpt-loop"))
    return dict(members=members, singles=singles, vmap=vmap, res_v=res_v, loop=loop,
                res_l=res_l, timings=timing.timing_report(), work=work)


@pytest.fixture(scope="module")
def jax_itc(jpop, tmp_path_factory):
    from dgen_tpu.sweep import SweepSimulation as JSweep

    sweep = JSweep(jpop.table, jpop.profiles, jpop.tariffs,
                   [j_inputs(jpop, 0.30), j_inputs(jpop, 0.0)], JCFG, JRC,
                   econ_years=ECON, labels=["itc30", "itc0"])
    res = sweep.run()
    out = str(tmp_path_factory.mktemp("jax-export") / "sweep")
    res.export(out)
    return sweep, res, out


# ---------------------------------------------------------------------------
# ScenarioStack
# ---------------------------------------------------------------------------

def _field_named(exc) -> str:
    return re.search(r"field '(\w+)'", str(exc.value)).group(1)


def test_stack_validation_names_offending_field(tpop, jpop):
    from dgen_tpu.models.scenario import ScenarioStackError as JStackError
    from dgen_tpu.models.scenario import stack_scenarios as j_stack
    from dgen_tpu.models.scenario import validate_scenario_statics as j_validate
    from dgen_tpu_torch.models.scenario import (
        ScenarioStackError,
        stack_scenarios,
        validate_scenario_statics,
    )

    import jax.numpy as jnp

    a, ja = t_inputs(tpop), j_inputs(jpop)
    bad = dc.replace(a, nem_cap_kw=torch.cat([a.nem_cap_kw, a.nem_cap_kw[:, :1]], dim=1))
    jbad = dc.replace(ja, nem_cap_kw=jnp.concatenate([ja.nem_cap_kw, ja.nem_cap_kw[:, :1]],
                                                      axis=1))
    with pytest.raises(ScenarioStackError) as got:
        stack_scenarios([a, bad])
    with pytest.raises(JStackError) as want:
        j_stack([ja, jbad])
    assert str(got.value) == str(want.value)
    assert _field_named(got) == "nem_cap_kw"

    bad_dtype = dc.replace(a, itc_fraction=a.itc_fraction.to(torch.bfloat16))
    jbad_dtype = dc.replace(ja, itc_fraction=ja.itc_fraction.astype(jnp.bfloat16))
    with pytest.raises(ScenarioStackError) as got:
        validate_scenario_statics([a, bad_dtype])
    with pytest.raises(JStackError) as want:
        j_validate([ja, jbad_dtype])
    assert _field_named(got) == _field_named(want) == "itc_fraction"
    with pytest.raises(ScenarioStackError, match="zero scenarios"):
        stack_scenarios([])

    stack = stack_scenarios([a, t_inputs(tpop, itc=0.0)])
    assert stack.n_scenarios == 2 and stack.n_years == Y
    assert stack.inputs.itc_fraction.shape == (2, Y, 3)
    np.testing.assert_array_equal(stack.scenario(1).itc_fraction.numpy(), 0.0)
    np.testing.assert_array_equal(stack.scenario(0).bass_p.numpy(), a.bass_p.numpy())


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _closing_caps(pop):
    caps = np.full((Y, pop.table.n_states), 1e30, np.float32)
    caps[1:] = 1e3
    return caps


def _nem_table(table, module):
    """The table with every agent on a net-metering tariff (0, 2 or 5 of
    the synthetic corpus), so an open NEM cap proves net_billing False."""
    rng = np.random.default_rng(0)
    tidx = np.asarray([0, 2, 5], np.int32)[rng.integers(0, 3, table.n_agents)]
    if module == "torch":
        t = torch.from_numpy(tidx)
    else:
        import jax.numpy as jnp

        t = jnp.asarray(tidx)
    return dc.replace(table, tariff_idx=t, tariff_switch_idx=t)


@pytest.mark.parametrize("width", [1, 8, 9])
def test_plan_groups_and_modes_equal_jax(tpop, jpop, width):
    from dgen_tpu.sweep import plan_sweep as j_plan

    years = list(TCFG.model_years)
    itcs = np.linspace(0.30, 0.0, width)
    # one closing-cap scenario beside width open ones on an all-NEM
    # table: two flag groups, first-seen order
    t_members = [t_inputs(tpop, v) for v in itcs] + [
        t_inputs(tpop, nem_cap_kw=_closing_caps(tpop))]
    j_members = [j_inputs(jpop, v) for v in itcs] + [
        j_inputs(jpop, nem_cap_kw=_closing_caps(jpop))]
    kw = dict(econ_years=25, sizing_iters=6, hbm_bytes=None)
    for t_tab, j_tab in ((tpop.table, jpop.table),
                         (_nem_table(tpop.table, "torch"), _nem_table(jpop.table, "jax"))):
        for members, jmembers in ((t_members[:width], j_members[:width]),
                                  (t_members, j_members)):
            got = plan_sweep(members, years, table=t_tab, tariffs=tpop.tariffs, **kw)
            want = j_plan(jmembers, years, table=j_tab, tariffs=jpop.tariffs, **kw)
            assert [(g.indices, g.net_billing, g.mode) for g in got.groups] == \
                [(g.indices, g.net_billing, g.mode) for g in want.groups]
            assert got.agent_chunk is want.agent_chunk is None
            assert got.n_scenarios == want.n_scenarios
    # the widest group decides the vmap width cap
    mode = plan_sweep(t_members[:width], years, table=tpop.table, tariffs=tpop.tariffs,
                      **kw).groups[0].mode
    assert mode == (MODE_VMAP if width <= 8 else MODE_LOOP)


def test_plan_budget_modes_and_error(tpop):
    years = list(TCFG.model_years)
    members = [t_inputs(tpop, v) for v in (0.3, 0.1, 0.0)]
    kw = dict(table=tpop.table, tariffs=tpop.tariffs, econ_years=25, sizing_iters=6)
    plan = plan_sweep(members, years, hbm_bytes=256 * 1024**3, **kw)
    assert [(g.indices, g.mode) for g in plan.groups] == [((0, 1, 2), MODE_VMAP)]
    assert plan.agent_chunk == 0
    # a mid budget: vmap survives, chunked, S x chunk rows bounded
    big = tsynth.generate_population(512, device="cpu", **POP_KW)
    big_members = [t_inputs(big) for _ in range(3)]
    mid = plan.per_agent_bytes * 3 * 256 + 3 * big.table.n_agents * 240
    plan_mid = plan_sweep(big_members, years, hbm_bytes=int(mid / 0.8 * 1.05),
                          table=big.table, tariffs=big.tariffs, econ_years=25,
                          sizing_iters=6)
    assert plan_mid.groups[0].mode == MODE_VMAP
    assert plan_mid.agent_chunk and plan_mid.agent_chunk % 128 == 0
    assert plan_mid.agent_chunk < big.table.n_agents
    # a starved budget: the loop, or with the budget enforced the error,
    # which names the card's budget and the byte model
    assert plan_sweep(members, years, hbm_bytes=8 * 1024**2, enforce_budget=False,
                      **kw).groups[0].mode == MODE_LOOP
    with pytest.raises(SweepBudgetError, match=r"over budget.*budgets 0\.01 GiB \(80% of "
                                               r"0\.01 GiB\).*per_agent_step_bytes"):
        plan_sweep(members, years, hbm_bytes=8 * 1024**2, **kw)
    # the member axis counts like the scenario axis
    assert plan_sweep(members[:1], years, hbm_bytes=None, n_members=9,
                      **kw).groups[0].mode == MODE_LOOP
    # a mesh is the ranks' RankTopology (tests/test_torch_sweep_ranks.py runs
    # them): on two ranks every group loops over a rank's shard, its chunk
    # from the rank's share of the card
    from dgen_tpu_torch.parallel.mesh import RankTopology

    with pytest.raises(TypeError, match="RankTopology"):
        plan_sweep(members, years, mesh=object(), **kw)
    two = RankTopology(hosts=1, devices=2, rank=0, local_rank=0,
                       device=torch.device("cpu"))
    ranked = plan_sweep(members, years, mesh=two, hbm_bytes=256 * 1024**3, **kw)
    assert [g.mode for g in ranked.groups] == [MODE_LOOP]
    assert ranked.mesh_shape == (1, 2) and ranked.global_hbm_bytes == 512 * 1024**3
    assert ranked.agent_chunk == 0


# ---------------------------------------------------------------------------
# Sweeps against single runs and against the JAX package
# ---------------------------------------------------------------------------

def test_identical_scenario_sweep_equals_single_run(tpop, itc_runs):
    inputs, ref = itc_runs["members"][0], itc_runs["singles"][0]
    sweep = sweep_of(tpop, [inputs] * 2)
    assert [g.mode for g in sweep.plan.groups] == [MODE_VMAP]
    res = sweep.run()
    # one copy of the banks: every sibling holds the base's tensors
    for sim in sweep.sims:
        assert sim.profiles is sweep.base.profiles
        assert sim.table is sweep.base.table
        assert sim.tariffs is sweep.base.tariffs
    assert res.bank_bytes_shared == sum(
        t.numel() * t.element_size()
        for t in (tpop.profiles.load, tpop.profiles.solar_cf, tpop.profiles.wholesale))
    for s in range(2):
        assert_same_run(res.runs[s], ref, f"scenario {s}")
    for s_rep in res.delta_report()["scenarios"]:
        assert s_rep["final"]["system_kw_cum_delta"] == 0.0


def test_itc_sweep_equals_independent_runs_in_both_modes(itc_runs):
    assert [g.mode for g in itc_runs["vmap"].plan.groups] == [MODE_VMAP]
    assert [g.mode for g in itc_runs["loop"].plan.groups] == [MODE_LOOP]
    for res, mode in ((itc_runs["res_v"], "vmap"), (itc_runs["res_l"], "loop")):
        for s in range(2):
            assert_same_run(res.runs[s], itc_runs["singles"][s], f"{mode} scenario {s}")
    m = itc_runs["vmap"].base.host_mask
    s0, s1 = (r.summary(m)["system_kw_cum"][-1] for r in itc_runs["res_v"].runs)
    assert s1 < s0                     # the ITC axis moved the answer
    # per-scenario timers: each loop sibling's years under its label
    rep = itc_runs["timings"]
    assert rep["hi:year_step"]["count"] == rep["lo:year_step"]["count"] == Y


def test_itc_sweep_matches_the_jax_sweep(itc_runs, jax_itc):
    jsweep, jres, _ = jax_itc
    res = itc_runs["res_v"]
    m = np.asarray(jsweep.base.host_mask)
    np.testing.assert_array_equal(m, res.host_mask)
    for s in range(2):
        js, ts = jres.runs[s].summary(m), res.runs[s].summary(m)
        for k in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=f"{s} {k}")
        assert set(res.runs[s].agent) == set(jres.runs[s].agent)
        for k, ref in jres.runs[s].agent.items():
            scale = float(np.abs(ref).max()) or 1.0
            np.testing.assert_allclose(res.runs[s].agent[k], ref, rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=f"{s} {k}")
    t_rep, j_rep = res.delta_report(), jres.delta_report()
    assert t_rep["baseline"] == j_rep["baseline"] and t_rep["years"] == j_rep["years"]
    for a, b in zip(t_rep["scenarios"], j_rep["scenarios"]):
        assert a["scenario"] == b["scenario"]
        np.testing.assert_allclose(a["system_kw_cum_delta"], b["system_kw_cum_delta"],
                                   rtol=1e-3, atol=1e-3)


def test_vmap_sweep_with_agent_chunk_equals_whole(tpop, itc_runs):
    sweep = sweep_of(tpop, itc_runs["members"],
                     rc=dc.replace(RC, agent_chunk=32, agent_pad_multiple=32))
    assert sweep.base._agent_chunk == 32 and sweep.base.table.n_agents == 96
    assert [g.mode for g in sweep.plan.groups] == [MODE_VMAP]
    res = sweep.run()
    for s in range(2):
        assert_same_run(res.runs[s], itc_runs["res_v"].runs[s], f"chunked scenario {s}")


# ---------------------------------------------------------------------------
# Checkpoint / resume at (scenario, year)
# ---------------------------------------------------------------------------

def test_sweep_resumes_at_scenario_year(tpop, itc_runs, tmp_path):
    # loop mode: scenario 0 complete, scenario 1 never started (a sweep
    # killed between scenarios)
    src = str(itc_runs["work"] / "ckpt-loop")
    assert sorted(os.listdir(src)) == ["scn=hi", "scn=lo"]
    d = str(tmp_path / "ckpt")
    shutil.copytree(src, d)
    shutil.rmtree(tckpt.scenario_dir(d, "lo"))
    sweep = sweep_of(tpop, itc_runs["members"], max_vmap_scenarios=1, labels=["hi", "lo"])
    res = sweep.run(checkpoint_dir=d, resume=True)
    assert res.runs[0].years == []
    assert_same_run(res.runs[1], itc_runs["singles"][1], "resumed loop scenario 1")
    assert sorted(os.listdir(d)) == ["scn=hi", "scn=lo"]

    # vmap mode: one stacked carry a year under scn=group0; the last
    # year dropped, the resumed group reruns it alone, bit for bit
    src = str(itc_runs["work"] / "ckpt-vmap")
    assert sorted(os.listdir(src)) == ["scn=group0"]
    assert tckpt.valid_years(src, scenario="group0") == list(TCFG.model_years)
    d2 = str(tmp_path / "ckpt-vmap")
    shutil.copytree(src, d2)
    n = itc_runs["vmap"].base.table.n_agents
    _, stacked = tckpt.restore_year(d2, n, 2016, device="cpu", scenario="group0",
                                    n_scenarios=2)
    assert stacked.market.system_kw_cum.shape == (2, n)
    shutil.rmtree(os.path.join(d2, "scn=group0", "2016"))
    res_v = sweep_of(tpop, itc_runs["members"]).run(checkpoint_dir=d2, resume=True)
    for s in range(2):
        assert res_v.runs[s].years == [2016]
        for k, v in itc_runs["res_v"].runs[s].agent.items():
            np.testing.assert_array_equal(res_v.runs[s].agent[k][0], v[-1], err_msg=k)
    np.testing.assert_array_equal(stacked.market.system_kw_cum[1].numpy(),
                                  itc_runs["res_v"].runs[1].agent["system_kw_cum"][-1])
    full = sweep_of(tpop, itc_runs["members"]).run(checkpoint_dir=d2, resume=True)
    assert all(r.years == [] for r in full.runs)


def test_checkpoint_scenario_layout_isolated(tmp_path):
    from dgen_tpu_torch.models.simulation import SimCarry

    d = str(tmp_path)
    c = SimCarry.zeros(8, "cpu")
    a = dc.replace(c, batt_adopters_cum=c.batt_adopters_cum + 1.0)
    b = dc.replace(c, batt_adopters_cum=c.batt_adopters_cum + 2.0)
    tckpt.save_year(d, 2014, a, scenario="s0")
    tckpt.save_year(d, 2014, b, scenario="s1")
    assert tckpt.latest_year(d, scenario="s0") == 2014
    assert tckpt.latest_year(d) is None        # the flat layout untouched
    assert float(tckpt.restore_year(d, 8, device="cpu", scenario="s0")[1]
                 .batt_adopters_cum[0]) == 1.0
    assert float(tckpt.restore_year(d, 8, device="cpu", scenario="s1")[1]
                 .batt_adopters_cum[0]) == 2.0
    assert tckpt.member_dir(d, 7).endswith("mem=007")
    with pytest.raises(ValueError, match="expected"):
        tckpt.restore_year(d, 8, 2014, device="cpu", scenario="s0", n_scenarios=2)


# ---------------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------------

def test_export_stamps_and_delta_report_match_jax(itc_runs, jax_itc, tmp_path):
    _, jres, jout = jax_itc
    res = itc_runs["res_v"]
    out = str(tmp_path / "sweep-out")
    res.export(out)
    live = str(itc_runs["work"] / "live")
    stamps = ("scenario", "scenario_index", "sweep_baseline", "sweep_n_scenarios")
    for i, label in enumerate(["itc30", "itc0"]):
        with open(os.path.join(out, f"scenario={label}", "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(jout, f"scenario={label}", "meta.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(live, f"scenario={label}", "meta.json")) as f:
            lmeta = json.load(f)
        assert {k: meta[k] for k in stamps} == {k: jmeta[k] for k in stamps} \
            == {k: lmeta[k] for k in stamps}
        assert meta["scenario_index"] == i and meta["sweep_baseline"] == "itc30"
        # the surfaces written as the sweep ran are the post-hoc export's
        for surface in ("agent_outputs", "finance_series"):
            for y in TCFG.model_years:
                rel = os.path.join(f"scenario={label}", surface, f"year={y}.npz")
                with open(os.path.join(out, rel), "rb") as a, \
                        open(os.path.join(live, rel), "rb") as b:
                    assert a.read() == b.read(), rel
        ao = texport.load_surface(os.path.join(out, f"scenario={label}"), "agent_outputs")
        assert set(ao["year"]) == set(TCFG.model_years)
    with open(os.path.join(out, "sweep.json")) as f:
        rep = json.load(f)
    with open(os.path.join(jout, "sweep.json")) as f:
        jrep = json.load(f)
    assert set(rep) == set(jrep)
    for k in ("baseline", "years", "groups"):
        assert rep[k] == jrep[k], k
    assert rep["bank_bytes_shared"] == res.bank_bytes_shared
    for a, b in zip(rep["scenarios"], jrep["scenarios"]):
        assert set(a) == set(b) and set(a["final"]) == set(b["final"])
        for k in ("adopters", "system_kw_cum", "system_kw_cum_delta", "adopters_delta"):
            np.testing.assert_allclose(a["final"][k], b["final"][k], rtol=1e-3, atol=1e-3)
    assert rep["scenarios"][1]["final"]["system_kw_cum_delta"] < 0.0
    # the CPU side's parquet layout of a sweep: a directory a scenario
    pq = texport.to_parquet(out, str(tmp_path / "pq"))
    assert os.path.isfile(os.path.join(pq, "sweep.json"))
    assert os.path.isfile(os.path.join(pq, "scenario=itc0", "agent_outputs",
                                       "year=2016.parquet"))


# ---------------------------------------------------------------------------
# The rate-switch (pair-kernel) and tariff-clustered paths
# ---------------------------------------------------------------------------

def test_rate_switch_sweep_through_the_pair_path(monkeypatch):
    """A rate-switch table: the vmap group's pair sums see both
    scenarios' rows in one call; each scenario equals its own run."""
    from dgen_tpu_torch.ops import billkernels as bk

    pop = tsynth.generate_population(48, device="cpu", rate_switch_frac=0.4, **POP_KW)
    members = [t_inputs(pop, 0.30), t_inputs(pop, 0.0)]
    refs = [single(pop, m) for m in members]
    rows = []
    pair = bk.month_pair_sums

    def spy(*args, **kw):
        rows.append(args[0].shape[0])
        return pair(*args, **kw)

    monkeypatch.setattr(bk, "month_pair_sums", spy)
    sweep = sweep_of(pop, members)
    assert sweep.base._rate_switch and [g.mode for g in sweep.plan.groups] == [MODE_VMAP]
    res = sweep.run()
    n = sweep.base.table.n_agents
    assert rows and set(rows) == {2 * n}
    for s in range(2):
        assert_same_run(res.runs[s], refs[s], f"rate switch scenario {s}")


def test_clustered_sweep_through_with_inputs(tpop):
    """A tariff-clustered table on net-metering tariffs: the siblings
    share the base's layout, compact banks and indices; two open-cap
    scenarios form a vmap group whose clusters price by the linear
    identity, a closing NEM cap a second group on the bucket sums; each
    scenario equals its own clustered run."""
    rc = dc.replace(RC, cluster_tariffs=True, agent_pad_multiple=16)
    pop = tsynth.generate_population(48, device="cpu", **POP_KW)
    pop = dc.replace(pop, table=_nem_table(pop.table, "torch"))
    members = [t_inputs(pop, 0.30), t_inputs(pop, 0.0),
               t_inputs(pop, nem_cap_kw=_closing_caps(pop))]
    refs = [single(pop, m, rc=rc) for m in members]
    sweep = sweep_of(pop, members, rc=rc)
    base = sweep.base
    assert base._cluster_layout is not None
    assert [(g.indices, g.net_billing, g.mode) for g in sweep.plan.groups] == \
        [((0, 1), False, MODE_VMAP), ((2,), True, MODE_VMAP)]
    for i, sim in enumerate(sweep.sims):
        assert sim._cluster_banks is base._cluster_banks
        assert sim._cluster_tidx is base._cluster_tidx
        assert sim.host_row_origin is base.host_row_origin
        assert {c.net_billing for c in sim._cluster_layout.clusters} == {i == 2}
    res = sweep.run()
    for s in range(3):
        assert_same_run(res.runs[s], refs[s], f"clustered scenario {s}")
    # an unpinned sibling re-proves each cluster's gate for its inputs
    sib = base.with_inputs(members[2])
    assert sib._net_billing is True
    assert sib._cluster_layout == base._cluster_layout.with_flags(
        base._cluster_flags(sib.inputs))
    with pytest.raises(ValueError, match="inputs cover"):
        base.with_inputs(tscen.uniform_inputs(
            tcfg.ScenarioConfig(start_year=2014, end_year=2014, anchor_years=()),
            n_groups=pop.table.n_groups, n_regions=pop.n_regions, device="cpu"))


def test_host_row_origin_composes_padding_and_clusters(tpop):
    rc = dc.replace(RC, cluster_tariffs=True, agent_pad_multiple=16, agent_chunk=64)
    sim = Simulation(tpop.table, tpop.profiles, tpop.tariffs, t_inputs(tpop), TCFG, rc,
                     econ_years=ECON, device="cpu")
    origin = sim.host_row_origin
    assert len(origin) == sim.table.n_agents
    real = origin >= 0
    ids = tpop.table.agent_id.numpy()
    np.testing.assert_array_equal(sim.host_agent_id[real], ids[origin[real]])
    np.testing.assert_array_equal(sim.host_mask[~real], 0.0)
    assert sorted(origin[real]) == sorted(np.flatnonzero(tpop.table.mask.numpy() > 0))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_sweep_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    import functools

    from dgen_tpu_torch.sweep.__main__ import main

    # the CLI's population padded to 8 rows, not 128: the plain bucket
    # sums' cost follows the padded rows
    monkeypatch.setattr(tsynth, "generate_population",
                        functools.partial(tsynth.generate_population, pad_multiple=8))

    out = str(tmp_path / "run")
    assert main(["--device", "cpu", "--agents", "8", "--states", "DE", "--end-year",
                 "2016", "--itc", "0.3,0.0", "--sizing-iters", "4", "--run-dir", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["scenarios"] == 2 and rec["device"] == "cpu"
    assert rec["groups"] == [{"mode": "vmap", "n": 2}]
    assert any("(baseline)" in ln for ln in lines)
    assert sorted(os.listdir(out)) == ["scenario=itc0-esc0-batt1",
                                       "scenario=itc0.3-esc0-batt1", "sweep.json"]


def test_fixed_order_segment_sum_ignores_zero_rows():
    """The card's segment sum (models.market._fixed_order_segment_sum):
    the sums index_add_ gives, to float32 rounding, and the same bits
    whatever zero rows pad the table or sit among the rows."""
    from dgen_tpu_torch.models import market

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random(1000, dtype=np.float32))
    x[torch.from_numpy(rng.random(1000) < 0.3)] = 0.0
    idx = torch.from_numpy(rng.integers(0, 7, 1000).astype(np.int32))
    got = market._fixed_order_segment_sum(x, idx, 7)
    want = torch.zeros(7).index_add_(0, idx.long(), x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    padded = market._fixed_order_segment_sum(
        torch.cat([x[:500], torch.zeros(40), x[500:], torch.zeros(300)]),
        torch.cat([idx[:500], torch.full((40,), 3, dtype=torch.int32), idx[500:],
                   torch.zeros(300, dtype=torch.int32)]), 7)
    assert torch.equal(padded, got)
    assert torch.equal(market._fixed_order_segment_sum(
        torch.zeros(5), torch.zeros(5, dtype=torch.int32), 3), torch.zeros(3))
