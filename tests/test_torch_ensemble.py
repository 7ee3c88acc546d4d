"""The Monte-Carlo ensemble of the PyTorch port (``dgen_tpu_torch.ensemble``)
against its own single runs and against the JAX package's ensemble
(``dgen_tpu.ensemble``), on the population of tests/test_ensemble.py:
96 agents over DE and CA, seed 11, model years 2014-2016, sizing_iters 6,
and a 5-year cash-flow horizon (``econ_years=5``, both packages alike;
the plain bucket sums set the CPU's pace) with a tripled retail price,
so systems pay back within it and agents adopt.

The port's draws are its own (``SeedSequence([seed, member, axis])``
numpy generators, not ``jax.random``'s bits), so they are held to their
contract: restart-stable, independent of the ensemble's width, only the
drawn axes moved, and over 4,096 members the lognormal factors' means 1
and the walks' log-steps of mean 0 and the spec's sd, each within 3
standard errors. The engine is held to JAX's by feeding it JAX's
``draw_members`` output: the quantile bands agree within the curves'
rtol 1e-3. The E = 1 zero-draw ensemble equals ``Simulation.run`` byte
for byte, and vmap and loop modes give the same members bit for bit.

Not here: ``test_ensemble_steady_state_compiles_nothing`` (the retrace
guard, ``ROADMAP.md`` item 12: PyTorch compiles nothing to retrace).
"""

import dataclasses as dc
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch import convert
from dgen_tpu_torch.ensemble import (
    COHORT_NEVER,
    DEFAULT_DRAWS,
    CohortSchedule,
    DrawSpec,
    EnsembleSimulation,
    EnsembleStats,
    cohort_alive_mask,
    draw_members,
    member_key,
)
from dgen_tpu_torch.ensemble import cohorts as tcohorts
from dgen_tpu_torch.ensemble import draws as tdraws
from dgen_tpu_torch.ensemble.stats import quantiles_np
from dgen_tpu_torch.io import checkpoint as tckpt
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation
from dgen_tpu_torch.sweep import MODE_LOOP, MODE_VMAP

ECON = 5
POP_KW = dict(states=["DE", "CA"], seed=11, pad_multiple=32)
CFG_KW = dict(name="ens-t", start_year=2014, end_year=2016, anchor_years=())
TCFG = tcfg.ScenarioConfig(**CFG_KW)
JCFG = jcfg.ScenarioConfig(**CFG_KW)
RC = tcfg.RunConfig(sizing_iters=6)
JRC = jcfg.RunConfig(sizing_iters=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tpop():
    return tsynth.generate_population(96, device="cpu", **POP_KW)


def overrides(pop):
    """A tripled retail price (systems pay back within the 5-year
    horizon, so agents adopt) and a battery attachment rate of 0.3."""
    y = len(TCFG.model_years)
    return {"elec_price_multiplier": np.full((y, pop.n_regions, 3), 3.0, np.float32),
            "attachment_rate": np.full(pop.table.n_groups, 0.3, np.float32)}


@pytest.fixture(scope="module")
def inputs(tpop):
    return tscen.uniform_inputs(TCFG, n_groups=tpop.table.n_groups,
                                n_regions=tpop.n_regions, overrides=overrides(tpop),
                                device="cpu")


def make_ens(pop, inputs, **kw):
    return EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs, TCFG,
                              kw.pop("run_config", RC), econ_years=ECON, device="cpu", **kw)


@pytest.fixture(scope="module")
def modes(tpop, inputs, tmp_path_factory):
    """E = 2 under DEFAULT_DRAWS, seed 3, collected and checkpointed, in
    vmap mode and in loop mode."""
    work = tmp_path_factory.mktemp("ens")
    out = {}
    for mode, kw in ((MODE_VMAP, {}), (MODE_LOOP, dict(max_vmap_members=1))):
        ens = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS, **kw)
        assert ens.mode == mode
        d = str(work / mode)
        out[mode] = (ens, ens.run(collect=True, checkpoint_dir=d), d)
    return out


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def test_zero_draws_return_base_object(inputs):
    assert all(m is inputs for m in draw_members(inputs, DrawSpec(), 3, seed=0))
    assert DrawSpec().is_zero and not DEFAULT_DRAWS.is_zero
    with pytest.raises(ValueError, match="bass_p_sd"):
        DrawSpec(bass_p_sd=-1.0)
    assert DrawSpec.from_json(DEFAULT_DRAWS.to_json()) == DEFAULT_DRAWS


def _leaves(m):
    return {f.name: getattr(m, f.name).numpy() for f in dc.fields(m)}


def test_draws_are_restart_stable_and_order_free(inputs):
    a = draw_members(inputs, DEFAULT_DRAWS, 4, seed=123)
    b = draw_members(inputs, DEFAULT_DRAWS, 4, seed=123)
    for ma, mb in zip(a, b):
        for k, v in _leaves(ma).items():
            np.testing.assert_array_equal(v, _leaves(mb)[k], err_msg=k)
    wide = draw_members(inputs, DEFAULT_DRAWS, 8, seed=123)
    for k, v in _leaves(a[2]).items():
        np.testing.assert_array_equal(v, _leaves(wide[2])[k], err_msg=k)
    # a member alone draws what it draws among its siblings
    alone = tdraws.draw_member(inputs, DEFAULT_DRAWS, member_key(123, 2))
    np.testing.assert_array_equal(alone.bass_q.numpy(), a[2].bass_q.numpy())
    c = draw_members(inputs, DEFAULT_DRAWS, 4, seed=124)
    assert not np.array_equal(a[1].bass_p.numpy(), c[1].bass_p.numpy())
    # turning one axis off leaves the others' draws as they were
    no_p = draw_members(inputs, dc.replace(DEFAULT_DRAWS, bass_p_sd=0.0, retail_sd=0.0),
                        4, seed=123)
    np.testing.assert_array_equal(no_p[1].bass_q.numpy(), a[1].bass_q.numpy())
    np.testing.assert_array_equal(no_p[1].wholesale_multiplier.numpy(),
                                  a[1].wholesale_multiplier.numpy())
    np.testing.assert_array_equal(no_p[1].bass_p.numpy(), inputs.bass_p.numpy())


def test_draws_perturb_only_drawn_axes(inputs):
    (m,) = draw_members(inputs, DrawSpec(bass_p_sd=0.2), 1, seed=5)
    assert not np.array_equal(m.bass_p.numpy(), inputs.bass_p.numpy())
    for k, v in _leaves(m).items():
        if k != "bass_p":
            np.testing.assert_array_equal(v, _leaves(inputs)[k], err_msg=k)
    (full,) = draw_members(inputs, DEFAULT_DRAWS, 1, seed=5)
    moved = {k for k, v in _leaves(full).items() if not np.array_equal(v, _leaves(inputs)[k])}
    assert moved == {"bass_p", "bass_q", "elec_price_multiplier", "elec_price_escalator",
                     "wholesale_multiplier", "pv_capex_per_kw", "pv_capex_per_kw_combined",
                     "batt_capex_per_kwh", "batt_capex_per_kw", "batt_capex_per_kwh_combined"}
    # year 0 of each walk is pinned (the observed base year)
    np.testing.assert_array_equal(full.elec_price_multiplier[0].numpy(),
                                  inputs.elec_price_multiplier[0].numpy())
    # the escalator is re-derived from the shocked multiplier
    np.testing.assert_array_equal(
        full.elec_price_escalator.numpy(),
        tscen.escalator_from_multipliers(full.elec_price_multiplier.numpy(),
                                         inputs.years.numpy().astype(np.int64)))


def test_draw_moments_over_4096_members():
    """Mean-preserving lognormals (mean 1) and zero-mean walks of the
    spec's sd, within 3 standard errors, on a small base (one state,
    nine years) so 4,096 members stay cheap."""
    cfg = tcfg.ScenarioConfig(start_year=2014, end_year=2022, year_step=1, anchor_years=())
    n_years = len(cfg.model_years)
    base = tscen.uniform_inputs(cfg, n_groups=3, n_regions=1, device="cpu")
    spec = DEFAULT_DRAWS
    members = draw_members(base, spec, 4096, seed=2024)
    n = len(members)

    def within_3se(x, mean, what):
        x = np.asarray(x, np.float64)
        se = x.std(ddof=1) / np.sqrt(x.size)
        assert abs(x.mean() - mean) < 3 * se, (what, x.mean(), se)

    p = np.stack([m.bass_p.numpy() / base.bass_p.numpy() for m in members])
    q = np.stack([m.bass_q.numpy() / base.bass_q.numpy() for m in members])
    pv = np.asarray([m.pv_capex_per_kw[0, 0].item() / base.pv_capex_per_kw[0, 0].item()
                     for m in members])
    batt = np.asarray([m.batt_capex_per_kw[0, 0].item() / base.batt_capex_per_kw[0, 0].item()
                       for m in members])
    for x, what in ((p, "bass_p"), (q, "bass_q"), (pv, "pv capex"), (batt, "batt capex")):
        within_3se(x, 1.0, what)
    for field, sd in (("elec_price_multiplier", spec.retail_sd),
                      ("wholesale_multiplier", spec.wholesale_sd)):
        paths = np.stack([getattr(m, field).numpy().reshape(n_years, -1)[:, 0]
                          for m in members])
        steps = np.diff(np.log(paths.astype(np.float64)), axis=1).reshape(-1)
        within_3se(steps, 0.0, f"{field} log-steps")
        # sample sd within 3 standard errors of sd (se ~ sd / sqrt(2 (n - 1)))
        assert abs(steps.std(ddof=1) - sd) < 3 * sd / np.sqrt(2 * (steps.size - 1)), field
    assert n == 4096


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_e1_zero_draw_equals_single_run_byte_for_byte(tpop, inputs):
    ref = Simulation(tpop.table, tpop.profiles, tpop.tariffs, inputs, TCFG, RC,
                     econ_years=ECON, device="cpu").run(collect=True)
    ens = make_ens(tpop, inputs, n_members=1, draws=DrawSpec())
    assert ens.mode == MODE_LOOP
    res = ens.run(collect=True)
    assert list(res[0].years) == list(ref.years)
    for k, v in ref.agent.items():
        assert res[0].agent[k].tobytes() == v.tobytes(), k
    band = res.quantiles.band("adopters")
    m = tpop.table.mask.numpy()
    nat = (ref.agent["number_of_adopters"] * m[None, :]).sum(axis=1)
    np.testing.assert_allclose(band["p50"], nat, rtol=1e-6)
    np.testing.assert_array_equal(band["p10"], band["p90"])


def test_loop_and_vmap_modes_agree(modes):
    (ens_v, res_v, _), (ens_l, res_l, _) = modes[MODE_VMAP], modes[MODE_LOOP]
    for m in range(2):
        assert list(res_v[m].years) == list(res_l[m].years)
        for k, v in res_l[m].agent.items():
            np.testing.assert_array_equal(res_v[m].agent[k], v, err_msg=f"mem{m}:{k}")
    for metric in res_l.quantiles.national:
        np.testing.assert_allclose(res_v.quantiles.national[metric],
                                   res_l.quantiles.national[metric], rtol=1e-6)
    # the draws moved the members apart
    assert not np.array_equal(res_v[0].agent["system_kw_cum"], res_v[1].agent["system_kw_cum"])


def test_quantiles_match_numpy(modes):
    ens, res, _ = modes[MODE_VMAP]
    mask = res.host_mask
    curves = np.stack([(res[m].agent["number_of_adopters"] * mask[None, :]).sum(axis=1)
                       for m in range(2)])
    ref = quantiles_np(curves, res.quantiles.quantiles).transpose(1, 0)
    np.testing.assert_allclose(res.quantiles.national["adopters"], ref, rtol=1e-5,
                               atol=1e-3)
    assert res.quantiles.n_members == 2
    y = len(TCFG.model_years)
    assert res.quantiles.state["adopters"].shape == (y, 3, ens.base.table.n_states)
    rt = EnsembleStats.from_json(res.quantiles.to_json())
    np.testing.assert_allclose(rt.national["adopters"], res.quantiles.national["adopters"],
                               rtol=1e-6)
    cols = res.quantiles.columns()
    assert len(cols["year"]) == y * 3 and "adopters" in cols
    # the device quantiles are torch.quantile's linear interpolation
    from dgen_tpu_torch.ensemble.stats import year_quantiles

    x = torch.tensor(np.random.default_rng(0).random((5, 4)), dtype=torch.float32)
    got = year_quantiles({"a": x}, torch.tensor([0.1, 0.5, 0.9]))["a"].numpy()
    np.testing.assert_allclose(got, quantiles_np(x.numpy(), (0.1, 0.5, 0.9)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Cohorts
# ---------------------------------------------------------------------------

def test_cohort_helpers_equal_jax():
    import jax.numpy as jnp

    from dgen_tpu.ensemble import cohorts as jcohorts

    rng = np.random.default_rng(0)
    mask = (rng.random(64) > 0.2).astype(np.float32)
    entry = np.where(rng.random(64) < 0.3, rng.integers(2015, 2020, 64), 0.0).astype(np.float32)
    mask[-4:] = 0.0
    entry[-4:] = COHORT_NEVER
    assert COHORT_NEVER == jcohorts.COHORT_NEVER
    for year in (2014.0, 2016.0, 2019.0, 2030.0):
        got = cohort_alive_mask(torch.from_numpy(mask), torch.from_numpy(entry), year).numpy()
        want = np.asarray(jcohorts.cohort_alive_mask(
            jnp.asarray(mask), jnp.asarray(entry), jnp.asarray(year, jnp.float32)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tcohorts.alive_mask_np(mask, entry, year),
                                      jcohorts.alive_mask_np(mask, entry, year))
    np.testing.assert_array_equal(tcohorts.potential_mask(mask, entry),
                                  jcohorts.potential_mask(mask, entry))
    e4 = np.asarray([0.0, 2016.0, 0.0, 2018.0], np.float32)
    origin = np.asarray([3, -1, 0, 2, 1], np.int64)
    np.testing.assert_array_equal(tcohorts.align_entry(e4, origin),
                                  jcohorts.align_entry(e4, origin))
    e = np.zeros(8, np.float32)
    e[2] = e[5] = 2016.0
    e[6] = COHORT_NEVER
    cs, jcs = CohortSchedule(e), jcohorts.CohortSchedule(e)
    assert cs.n_cohort_rows == jcs.n_cohort_rows == 2
    assert cs.counts_by_year() == jcs.counts_by_year() == {2016: 2}
    with pytest.raises(ValueError, match="1-D"):
        CohortSchedule(np.zeros((2, 2), np.float32))
    lg = np.ones((3, 2, 3), np.float32)
    for kw in (dict(sectors=(0,)), dict(start_year=2022), {}):
        np.testing.assert_array_equal(
            tcohorts.electrified_load_growth(lg, [2020, 2022, 2024], 0.10, **kw),
            np.asarray(jcohorts.electrified_load_growth(lg, [2020, 2022, 2024], 0.10, **kw)))


def test_cohort_entry_freezes_rows_until_entry_year(tpop, inputs):
    entry = np.zeros(tpop.table.n_agents, np.float32)
    alive = np.flatnonzero(tpop.table.mask.numpy() > 0)
    cohort = alive[-12:]
    entry[cohort] = 2016.0                # enters at the last model year
    ens = make_ens(tpop, inputs, n_members=2, seed=1, draws=DEFAULT_DRAWS,
                   entry_year=CohortSchedule(entry))
    assert ens.mode == MODE_VMAP
    res = ens.run(collect=True)
    placed = np.isin(res.host_agent_id, cohort) & (res.host_mask > 0)
    assert placed.sum() == 12
    for m in range(2):
        adopters = res[m].agent["number_of_adopters"]
        # before entry the cohort's rows are masked: exact zeros
        assert np.all(adopters[0][placed] == 0.0)
        assert adopters[-1][placed].sum() > 0.0
    year0_alive = res.host_mask * ~placed
    curves = np.asarray([(res[m].agent["number_of_adopters"][0] * year0_alive).sum()
                         for m in range(2)])
    np.testing.assert_allclose(res.quantiles.national["adopters"][0, 1],
                               np.quantile(curves, 0.5), rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="entry_year covers"):
        make_ens(tpop, inputs, n_members=1, entry_year=np.zeros(3, np.float32))


# ---------------------------------------------------------------------------
# Checkpoint / resume at (member, year)
# ---------------------------------------------------------------------------

def test_resume_loop_mode_at_member_year(tpop, inputs, modes, tmp_path):
    ens, full, src = modes[MODE_LOOP]
    d = str(tmp_path / "loop")
    shutil.copytree(src, d)
    m1 = tckpt.member_dir(d, 1)
    assert tckpt.latest_year(m1) == 2016
    shutil.rmtree(os.path.join(m1, "2016"))
    ens2 = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS,
                    max_vmap_members=1)
    res = ens2.run(collect=True, checkpoint_dir=d, resume=True)
    assert [r.years for r in res.runs] == [[], [2016]]
    for k, v in full.runs[1].agent.items():
        np.testing.assert_array_equal(res.runs[1].agent[k][0], v[-1], err_msg=k)
    # the stats sidecar restores the full horizon
    np.testing.assert_array_equal(res.quantiles.national["adopters"],
                                  full.quantiles.national["adopters"])


def test_resume_vmap_mode_stacked(tpop, inputs, modes, tmp_path):
    ens, full, src = modes[MODE_VMAP]
    assert sorted(os.listdir(src)) == ["ensemble_stats.json", "scn=members"]
    d = str(tmp_path / "vmap")
    shutil.copytree(src, d)
    shutil.rmtree(os.path.join(d, "scn=members", "2016"))
    ens2 = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS)
    res = ens2.run(collect=True, checkpoint_dir=d, resume=True)
    assert all(r.years == [2016] for r in res.runs)
    for m in range(2):
        for k, v in full.runs[m].agent.items():
            np.testing.assert_array_equal(res.runs[m].agent[k][0], v[-1], err_msg=k)
    np.testing.assert_array_equal(res.quantiles.national["adopters"],
                                  full.quantiles.national["adopters"])
    again = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS).run(
        checkpoint_dir=d, resume=True)
    assert all(r.years == [] for r in again.runs)


def test_stale_stats_sidecar_is_ignored(tpop, inputs, modes, tmp_path):
    """A sidecar of another configuration (here another E, its blocks
    otherwise this run's own) does not feed a resumed run: the restored
    years' statistics are then missing, which the run refuses to
    interpolate over."""
    from dgen_tpu_torch.ensemble.driver import STATS_FILE

    _, full, src = modes[MODE_VMAP]
    d = str(tmp_path / "stale")
    shutil.copytree(src, d)
    path = os.path.join(d, STATS_FILE)
    with open(path) as f:
        state = json.load(f)
    ens = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS)
    assert ens._load_stats_state(d, "vmap") is not None
    assert ens._load_stats_state(d, "loop") is None
    with open(path, "w") as f:
        json.dump({**state, "n_members": 99}, f)
    assert ens._load_stats_state(d, "vmap") is None
    shutil.rmtree(os.path.join(d, "scn=members", "2016"))
    with pytest.raises(ValueError, match=r"missing ensemble stats for year indices \[0\]"):
        ens.run(checkpoint_dir=d, resume=True)


def test_env_knobs_set_members_and_seed(tpop, inputs, monkeypatch):
    from dgen_tpu_torch.ensemble.driver import ENV_MEMBERS, ENV_SEED

    monkeypatch.setenv(ENV_MEMBERS, "3")
    monkeypatch.setenv(ENV_SEED, "42")
    ens = make_ens(tpop, inputs)
    assert ens.n_members == 3 and ens.seed == 42
    monkeypatch.delenv(ENV_MEMBERS)
    monkeypatch.delenv(ENV_SEED)
    ens = make_ens(tpop, inputs)
    assert ens.n_members == 1 and ens.seed == 0 and ens.mode == MODE_LOOP


# ---------------------------------------------------------------------------
# The engine against the JAX package's, on JAX's draws
# ---------------------------------------------------------------------------

def test_engine_on_jax_draws_matches_jax_quantiles(tpop, inputs):
    from dgen_tpu.ensemble import DEFAULT_DRAWS as J_DRAWS
    from dgen_tpu.ensemble import EnsembleSimulation as JEnsemble
    from dgen_tpu.ensemble import draw_members as j_draw_members

    jpop = jsynth.generate_population(96, **POP_KW)
    jin = jscen.uniform_inputs(JCFG, n_groups=jpop.table.n_groups, n_regions=jpop.n_regions,
                               overrides=overrides(jpop))
    jens = JEnsemble(jpop.table, jpop.profiles, jpop.tariffs, jin, JCFG, JRC, n_members=2,
                     seed=3, draws=J_DRAWS, econ_years=ECON)
    jres = jens.run()
    jmembers = j_draw_members(jin, J_DRAWS, 2, 3)
    ens = make_ens(tpop, inputs, n_members=2, seed=3, draws=DEFAULT_DRAWS)
    assert ens.mode == jens.mode == MODE_VMAP
    ens.members = [convert.scenario_inputs({f.name: np.asarray(getattr(m, f.name))
                                            for f in dc.fields(m)}, device="cpu")
                   for m in jmembers]
    res = ens.run()
    assert list(res.quantiles.years) == list(jres.quantiles.years)
    assert res.quantiles.quantiles == jres.quantiles.quantiles
    for metric, want in jres.quantiles.national.items():
        np.testing.assert_allclose(res.quantiles.national[metric], want, rtol=1e-3,
                                   err_msg=metric)
    for metric, want in jres.quantiles.state.items():
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(res.quantiles.state[metric], want, rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=metric)


def test_ensemble_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    import functools

    from dgen_tpu_torch.ensemble.__main__ import main

    # the CLI's population padded to 8 rows, not 128: the plain bucket
    # sums' cost follows the padded rows
    monkeypatch.setattr(tsynth, "generate_population",
                        functools.partial(tsynth.generate_population, pad_multiple=8))

    out = str(tmp_path / "run")
    assert main(["--device", "cpu", "--agents", "8", "--states", "DE", "--end-year", "2016",
                 "--members", "2", "--sizing-iters", "4", "--cohort-rows", "2",
                 "--cohort-year", "2016", "--check-parity", "--run-dir", out]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["members"] == 2 and rec["mode"] == MODE_VMAP and rec["cohort_rows"] == 2
    assert rec["years"] == [2014, 2016] and rec["parity"] is True
    assert set(rec["adopters_band"]) == {"p10", "p50", "p90"}
    with open(os.path.join(out, "ensemble.json")) as f:
        assert json.load(f)["n_members"] == 2
