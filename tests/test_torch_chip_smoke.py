"""chip_smoke.py's library yardstick computes each bucket-sums row's
function: one bmm of the pre-formed relu(net) (and net) with the one-hot
M that ``bmm_operands`` forms from a row's operands gives the row's plain
outputs, on full-hour and compacted lanes, with periods outside [0, P)
counted for the sell sum alone, for one tariff and two, at 12 P + 1
columns and wider. ``held_year`` holds the first month, signed-month and
sizing and remat-pass dispatch launches of a streaming year against the
plain versions, block by block, and fails on one agent off. The run
outputs phase [3f]'s small-scale A/B runs both paths (its four runs are
held in tests/test_torch_chip_smoke_outputs.py). The sweep and ensemble
phase [3i] passes on the
CPU at 16 agents, and its checkers fail on one agent's npv one ulp off
between modes, on a quantile moved 1e-5, and on a sibling that copies a
bank."""

import contextlib
import importlib.util
import json
import os

import pytest
import torch

from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {name: os.path.join(ROOT, "tests", "fixtures", name)
          for name in ("golden_adoption.json", "golden_capflip.json")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()

#: compacted months of 128-lane multiples
COMPACTED = layout.seg_offsets([384, 256, 384, 512, 512, 512, 512, 512, 384, 384,
                                256, 256])


def _operands(form, p, offsets, seed):
    g = torch.Generator().manual_seed(seed)
    n, r, lanes = 3, 5, offsets[-1]

    def rand(scale):
        return torch.rand((n, lanes), generator=g, dtype=torch.float64).float() * scale

    def periods():
        per = torch.randint(0, p, (n, lanes), generator=g, dtype=torch.int32)
        per[0, 3], per[1, 7] = -1, p  # lanes that count for the sell sum alone
        return per

    load, gen, sell, sell_b = rand(3.0), rand(0.9), rand(0.1), rand(0.1)
    scales = torch.rand((n, r), generator=g) * 4.0
    if form.startswith("dot"):
        per = torch.randint(0, p, (n, lanes), generator=g, dtype=torch.int32)
        return ((load, gen, sell, bk.hourly_bucket_ids(per, p), scales, p,
                 form == "dot_signed"), bk.dot_sums_plain)
    if form == "pair":
        return ((load, gen, sell, periods(), sell_b, periods(), scales, offsets, p),
                bk.month_pair_sums_plain)
    return ((load, gen, sell, periods(), scales, offsets, p, form == "month_signed"),
            bk.month_sums_plain)


@pytest.mark.parametrize("p", [1, 2, 10])
@pytest.mark.parametrize("form,offsets", [
    ("month", layout.FULL_OFFSETS), ("month_signed", layout.FULL_OFFSETS),
    ("month_signed", COMPACTED), ("pair", layout.FULL_OFFSETS), ("pair", COMPACTED),
    ("dot", layout.FULL_OFFSETS), ("dot_signed", layout.FULL_OFFSETS),
], ids=lambda v: v if isinstance(v, str) else f"{v[-1]}lanes")
def test_bmm_yardstick_computes_the_rows_function(form, offsets, p):
    args, plain = _operands(form, p, offsets, seed=p)
    terms = cs.sums_terms(args)
    for cols in (12 * p + 1, 128):
        a, m = cs.bmm_operands(terms, 0, 3, cols)
        want = cs.bmm_outputs(torch.bmm(a.double(), m.double()), terms, cols)
        got = plain(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g.double(), w, rtol=1e-5, atol=1e-4)


def test_bmm_operands_cut_agent_rows():
    args, _ = _operands("pair", 2, layout.FULL_OFFSETS, seed=5)
    terms = cs.sums_terms(args)
    a, m = cs.bmm_operands(terms, 1, 3, 25)
    assert tuple(a.shape) == (2, 5, 8760) and tuple(m.shape) == (2, 8760, 50)
    whole_a, whole_m = cs.bmm_operands(terms, 0, 3, 25)
    assert torch.equal(a, whole_a[1:]) and torch.equal(m, whole_m[1:])


#: the launch counts of a default-path run: held_year holds the first
#: launch of each kernel a run launched (the plain path here launches none)
MONTH_LAUNCHES = {"month": 1, "month_signed": 1}


@pytest.fixture(scope="module")
def chunked_sim():
    """A small streaming world on the CPU: 64 agents padded to 128 rows in
    4 chunks of 32, hourly and storage on, batteries allocated."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig

    sim, _, _ = presets.build("ercot-all-sector", n_agents=64, end_year=2014,
                              device="cpu", attachment_rate=cs.CHUNK_ATTACHMENT,
                              run_config=RunConfig(agent_chunk=32, sizing_iters=4))
    assert cs.n_chunks(sim) == 4 and sim.with_hourly
    return sim


def test_held_year_holds_every_first_launch(chunked_sim, monkeypatch, capsys):
    monkeypatch.setattr(cs, "HELD_ROWS", 48)     # blocks that cut a chunk
    cs.held_year(chunked_sim, "cpu", MONTH_LAUNCHES)
    out = capsys.readouterr()
    line = out.out + out.err
    for key in ("'month'", "'month_signed'", "dispatch (sizing)",
                "dispatch (remat pass)"):
        assert key in line


@pytest.mark.parametrize("where", ["month_signed", "dispatch (sizing)",
                                   "dispatch (remat pass)"])
def test_held_year_catches_a_launch_off_its_plain_version(chunked_sim, monkeypatch,
                                                          where):
    """A wrapper that disagrees with its plain version in one agent of a
    later block fails the check (the mutant stands in for the kernel)."""
    from dgen_tpu_torch.ops import dispatch

    monkeypatch.setattr(cs, "HELD_ROWS", 16)
    if where == "month_signed":
        month = bk.month_sums

        def mutant(*args):
            out = month(*args)
            if args[7]:
                out[0][20] *= 1.01
            return out

        monkeypatch.setattr(bk, "month_sums", mutant)
    else:
        kernel, calls = dispatch.dispatch_battery, []
        which = 0 if where == "dispatch (sizing)" else cs.n_chunks(chunked_sim)

        def mutant(*args, **kw):
            out = kernel(*args, **kw)
            if len(calls) == which:
                out.soc[20] += 1.0
            calls.append(1)
            return out

        monkeypatch.setattr(dispatch, "dispatch_battery", mutant)
    with pytest.raises(AssertionError, match="rows 16-31 .first: row 20"):
        cs.held_year(chunked_sim, "cpu", MONTH_LAUNCHES)


def test_held_year_holds_the_pair_kernel_and_catches_it(monkeypatch, capsys):
    """In a rate-switch world the pair kernel's first launch is held too,
    and a pair launch off its plain version in one agent fails."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig

    sim, _, _ = presets.build("ercot-all-sector", n_agents=64, end_year=2014,
                              device="cpu", rate_switch_frac=0.4,
                              run_config=RunConfig(agent_chunk=32, sizing_iters=4))
    assert sim._rate_switch and sim._net_billing
    launches = {"month_pair": 1, "month_signed": 1}
    monkeypatch.setattr(cs, "HELD_ROWS", 16)
    cs.held_year(sim, "cpu", launches)
    assert "'month_pair'" in capsys.readouterr().out
    pair = bk.month_pair_sums

    def mutant(*args):
        out = pair(*args)
        out[2][20] *= 1.01
        return out

    monkeypatch.setattr(bk, "month_pair_sums", mutant)
    with pytest.raises(AssertionError, match="month_pair: output 2 .* rows 16-31"):
        cs.held_year(sim, "cpu", launches)


def _golden(name):
    with open(GOLDEN[name]) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_checker_passes_the_pinned_curves(name):
    golden = _golden(name)
    worst = cs.check_golden(json.loads(json.dumps(golden)), golden, name)
    assert set(worst) == set(golden) and not any(worst.values())


def _moved(golden, key, how):
    curves = json.loads(json.dumps(golden))
    if how == "count":
        curves[key][len(curves[key]) // 2] += 1
    elif key == "adoption_checksum":
        curves[key] *= how
    elif isinstance(curves[key][-1], list):
        curves[key][-1][0] = curves[key][-1][0] * how + (0.06 if how > 1.001 else 0.0)
    else:
        curves[key][-1] *= how
    return curves


@pytest.mark.parametrize("name, key, how, fails", [
    ("golden_adoption.json", "adopters", 1.002, True),
    ("golden_adoption.json", "system_kw_cum", 1.002, True),
    ("golden_adoption.json", "cash_flow_total", 0.998, True),
    ("golden_adoption.json", "adoption_checksum", 1.002, True),
    ("golden_adoption.json", "state_hourly_abs_mwh", 1.002, True),
    ("golden_adoption.json", "kw_histogram", "count", True),
    ("golden_adoption.json", "adopters", 1.0005, False),
    ("golden_capflip.json", "batt_kwh_cum", 1.002, True),
    ("golden_capflip.json", "state_hourly_net_mwh", 1.002, True),
    ("golden_capflip.json", "nem_allowed", "count", True),
    ("golden_capflip.json", "system_kw_cum", 0.9995, False),
])
def test_golden_checker_catches_a_moved_metric(name, key, how, fails):
    """One curve moved by 0.2%, one histogram or NEM-eligible count moved
    by one, fails the contract and names the metric; 0.05% passes."""
    golden = _golden(name)
    curves = _moved(golden, key, how)
    if not fails:
        assert cs.check_golden(curves, golden, name)[key] > 0
        return
    with pytest.raises(AssertionError, match=f"contract fails: {key}"):
        cs.check_golden(curves, golden, name)


def test_golden_checker_refuses_missing_and_unknown_metrics():
    golden = _golden("golden_adoption.json")
    curves = json.loads(json.dumps(golden))
    del curves["kw_histogram"]
    with pytest.raises(AssertionError, match="kw_histogram not computed"):
        cs.check_golden(curves, golden, "golden")
    with pytest.raises(AssertionError, match="outside the contract"):
        cs.check_golden({**golden, "extra": [1.0]}, {**golden, "extra": [1.0]}, "golden")


def test_pipeline_ab_runs_both_paths_on_the_cpu(capsys):
    """[3f]'s small-scale A/B times sim.run() on the pipeline and on the
    serialized path, alternated, and reports both medians."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig

    out = cs.pipeline_ab(presets, RunConfig, sizes=((32, 2014),), pairs=2, device="cpu")
    assert set(out) == {32} and out[32]["pipeline"] > 0 and out[32]["serialized"] > 0
    assert 0 <= out[32]["won"] <= 2
    assert "pipeline vs serialized, 2 alternated pairs" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# [3h]: the tariff-clustered mixed world; [3g] (c): chunk invariance per agent
# ---------------------------------------------------------------------------

#: [3h] on the CPU: segments padded to 16 rows, 4 sizing iterations, a
#: 5-year cash-flow horizon, one model year
SMALL_3H = dict(agent_pad_multiple=16, sizing_iters=4)
SMALL_3H_RUN = dict(device="cpu", end_year=2014, knobs=SMALL_3H, econ_years=5)


@pytest.fixture(scope="module")
def mixed_runs(tmp_path_factory):
    """[3h] (a) and (b) on a 48-agent mixed world on the CPU; (b)'s two
    runs as its checker received them."""
    a = cs.mixed_world(48, str(tmp_path_factory.mktemp("3h")), device="cpu")
    seen = []
    real = cs.clustered_parity

    def keep(run_c, run_u, **kw):
        seen.append((run_c, run_u))
        return real(run_c, run_u, **kw)

    cs.clustered_parity = keep
    try:
        rec = cs.clustered_national(a["pop"], **SMALL_3H_RUN)
    finally:
        cs.clustered_parity = real
    return a, rec, seen[0]


def test_3h_mixed_world_and_clustered_parity_pass_on_the_cpu(mixed_runs):
    a, rec, (run_c, run_u) = mixed_runs
    assert a["report"]["n_clusters"] == 6 and a["bytes"] > 0
    assert rec["agents"] == 48 and rec["masked_rows"] == run_c[0].cluster_filler_rows > 0
    assert set(rec["fields"]) == set(cs.CLUSTER_FIELDS)
    assert run_c[0]._cluster_layout is not None and run_u[0]._cluster_layout is None


def _broken(run, how):
    import types

    import numpy as np

    sim, res = run
    mask = sim.host_mask.copy()
    agent = {k: v.copy() for k, v in res.agent.items()}
    if how == "moved":
        agent["npv"] = agent["npv"] * np.float32(1 + 1e-4)
    elif how == "dropped":
        mask[np.nonzero(mask > 0)[0][5]] = 0.0
    else:
        agent["new_adopters"][:, np.nonzero(mask == 0)[0][0]] = 1.0
    return (types.SimpleNamespace(host_agent_id=sim.host_agent_id, host_mask=mask),
            types.SimpleNamespace(agent=agent))


@pytest.mark.parametrize("how, match", [
    ("moved", "clustered vs unclustered npv"),
    ("dropped", "does not hold every agent once"),
    ("filler", "masked rows"),
])
def test_3h_checker_catches_a_broken_clustered_run(mixed_runs, how, match):
    _, _, (run_c, run_u) = mixed_runs
    cs.clustered_parity(run_c, run_u)
    with pytest.raises(AssertionError, match=match):
        cs.clustered_parity(_broken(run_c, how), run_u)


def test_3h_clustered_chunked_equals_whole_on_the_cpu(capsys):
    out = cs.cluster_chunk_invariance(48, 16, worlds={"default": {}}, **SMALL_3H_RUN)
    assert out["default"] == {f: 0 for f in cs.CHUNK_FIELDS}
    assert "equals clustered whole bit for bit" in capsys.readouterr().out


def _fake_run(payback, adopters, mask):
    import types

    import numpy as np

    n = len(mask)
    agent = {f: np.ones((1, n), np.float32) for f in ("system_kw", "npv", "batt_kwh")}
    agent["payback_period"] = np.asarray([payback], np.float32)
    agent["number_of_adopters"] = np.asarray([adopters], np.float32)
    return (types.SimpleNamespace(host_agent_id=np.arange(n), host_mask=np.asarray(mask)),
            types.SimpleNamespace(agent=agent))


@pytest.mark.parametrize("change, first", [
    (None, None),
    ("payback", "sizing"),
    ("adopters", "market"),
    ("padding", "export codes"),
])
def test_3h0_stage_gaps_name_the_first_stage_that_differs(change, first):
    mask = [1.0, 1.0, 1.0, 1.0, 0.0]
    payback, adopters = [3.0, 4.5, 7.25, 11.0, 0.0], [1.0, 2.0, 3.0, 4.0, 0.0]
    other_p, other_a = list(payback), list(adopters)
    if change == "payback":
        other_p[2] = 7.3
    elif change == "adopters":
        other_a[1] = 2.5
    elif change == "padding":
        other_p[4] = 30.1     # a padding row's payback grows the column's scale
    rec = cs.stage_gaps(_fake_run(payback, adopters, mask),
                        _fake_run(other_p, other_a, mask))
    assert rec["first_stage"] == first
    if change == "padding":
        assert rec["stages"]["sizing"]["agents_differ"] == 0
        assert rec["stages"]["export codes"]["agents_differ"] > 0


@pytest.mark.parametrize("change, fails", [
    (None, None),
    ("payback", "sizing"),
    ("adopters", "market"),
    ("padding", None),
])
def test_3g_chunk_check_fails_on_a_row_that_depends_on_the_chunk(change, fails, capsys):
    """[3g] (c)'s per-agent check: an agent whose sizing or market result
    moved with the chunk fails it; a padding row that only moves the
    export codes' scale is logged."""
    mask = [1.0, 1.0, 1.0, 1.0, 0.0]
    payback, adopters = [3.0, 4.5, 7.25, 11.0, 0.0], [1.0, 2.0, 3.0, 4.0, 0.0]
    other_p, other_a = list(payback), list(adopters)
    if change == "payback":
        other_p[0] = 3.0001
    elif change == "adopters":
        other_a[3] = 4.5
    elif change == "padding":
        other_p[4] = 30.1
    runs = _fake_run(other_p, other_a, mask), _fake_run(payback, adopters, mask)
    if fails:
        with pytest.raises(AssertionError, match=f"a row's {fails} result depends"):
            cs.chunk_gaps_checked(*runs, 64)
        return
    rec = cs.chunk_gaps_checked(*runs, 64)
    assert rec["first_stage"] == ("export codes" if change else None)
    assert "agent_chunk 64 against the automatic" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# [3i]: sweeps and ensembles
# ---------------------------------------------------------------------------

#: [3i] on the CPU: delaware-res (no storage), 4 sizing iterations, a
#: 10-year cash-flow horizon (agents adopt by 2016)
SMALL_3I = dict(name="delaware-res", n_agents=16, end_year=2016, device="cpu",
                econ_years=10, knobs=dict(sizing_iters=4))


@contextlib.contextmanager
def _small_pads():
    """The preset populations padded to 16 rows, not 128: the plain
    bucket sums' cost follows the padded rows."""
    import functools

    from dgen_tpu_torch.io import synth

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synth, "generate_population",
                   functools.partial(synth.generate_population, pad_multiple=16))
        yield


@pytest.fixture
def small_pads():
    with _small_pads():
        yield


@pytest.fixture(scope="module")
def sweep_phase(tmp_path_factory):
    """[3i] (a) and (c) on the CPU, with what their checkers received."""
    from dgen_tpu_torch import presets

    seen = {"same": [], "quantiles": []}
    same, quantiles = cs.check_same_members, cs.check_quantiles

    def keep_same(a, b, tag, *args):
        seen["same"].append((a, b, tag))
        return same(a, b, tag, *args)

    def keep_quantiles(stats, curves, *args):
        seen["quantiles"].append((stats, curves))
        return quantiles(stats, curves, *args)

    cs.check_same_members, cs.check_quantiles = keep_same, keep_quantiles
    try:
        with _small_pads():
            a = cs.national_sweep(presets, {}, 1.0, **SMALL_3I)
            c = cs.ensemble_phase(presets=presets, members=2, cohort_rows=4,
                                  workdir=str(tmp_path_factory.mktemp("3i")), **SMALL_3I)
    finally:
        cs.check_same_members, cs.check_quantiles = same, quantiles
    return a, c, seen


def test_3i_sweep_and_ensemble_pass_on_the_cpu(sweep_phase, capsys):
    a, c, seen = sweep_phase
    assert a["compared"] > 0 and c["compared"] > 0
    assert c["quantile_gap"] <= cs.QUANTILE_RTOL
    assert [tag for *_, tag in seen["same"]] == [
        "3i (a) vmap vs loop", "3i (c) vmap vs loop", "3i (c) E = 1 vs Simulation.run"]


def test_3i_checker_fails_on_one_agents_npv(small_pads):
    """A vmap/loop mismatch of one ulp in one agent's npv fails (a)."""
    import copy

    import numpy as np

    from dgen_tpu_torch import presets

    seen = []
    same = cs.check_same_members

    def keep(a, b, tag, *args):
        seen.append((a, b))
        return same(a, b, tag, *args)

    cs.check_same_members = keep
    try:
        cs.national_sweep(presets, {}, 1.0, **dict(SMALL_3I, end_year=2014))
    finally:
        cs.check_same_members = same
    (runs, ids, mask), loop = seen[0]
    bad = copy.deepcopy(runs)
    row = int(np.flatnonzero(mask > 0)[5])
    npv = bad[1].agent["npv"]
    npv[0, row] = np.nextafter(npv[0, row], np.float32(np.inf))
    with pytest.raises(AssertionError, match=r"run 1, npv: 1 agents differ \(first: agent "
                                             f"{int(ids[row])}"):
        cs.check_same_members((bad, ids, mask), loop, "3i (a) vmap vs loop")


def test_3i_checker_fails_on_a_quantile_moved_1e_5(sweep_phase):
    import dataclasses as dc

    *_, seen = sweep_phase
    stats, curves = seen["quantiles"][0]
    assert cs.check_quantiles(stats, curves) <= cs.QUANTILE_RTOL
    national = dict(stats.national)
    moved = national["adopters"].copy()
    moved[-1, 1] *= 1.0 + 1e-5
    national["adopters"] = moved
    with pytest.raises(AssertionError, match="adopters quantiles"):
        cs.check_quantiles(dc.replace(stats, national=national), curves)


def test_3i_memory_check_fails_on_a_sibling_that_copies_a_bank(small_pads):
    import dataclasses as dc

    from dgen_tpu_torch import presets
    from dgen_tpu_torch.sweep import SweepSimulation

    pop, cfg, inputs, hourly, _ = presets.world("delaware-res", 8, end_year=2014,
                                                device="cpu")
    sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs, [inputs, inputs], cfg,
                            device="cpu")
    assert sweep.sibling_bytes is None
    smallest = cs.check_shared_banks(sweep, sweep.sibling_bytes)
    assert smallest == min(t.numel() * 4 for t in (pop.profiles.load, pop.profiles.solar_cf,
                                                   pop.profiles.wholesale))
    with pytest.raises(AssertionError, match="a bank's worth"):
        cs.check_shared_banks(sweep, smallest)
    sib = sweep.sims[1]
    sib.profiles = dc.replace(sib.profiles, load=sib.profiles.load.clone())
    with pytest.raises(AssertionError, match="sibling 1 holds its own copy of the profiles"):
        cs.check_shared_banks(sweep, 0)


def test_3i_sweeps_against_single_runs_and_the_fault_pass_on_the_cpu(tmp_path, capsys,
                                                                     small_pads):
    """[3i] (b) on the CPU: the vmap sweep equals the single runs, and the
    supervised loop sweep resumes with the clean sweep's files."""
    from dgen_tpu_torch import presets

    out = cs.sweeps_vs_singles(presets, workdir=str(tmp_path), worlds=("default",),
                               **dict(SMALL_3I, end_year=2016))
    assert out["default"]["compared"] > 0
    assert out["default"]["same"] == 2 * 3 * 2 and out["default"]["approx"] == 3 * 2
    assert "resumed at (scenario itc0.1" in capsys.readouterr().out
