"""The single-card run supervisor of the PyTorch port
(``dgen_tpu_torch.resilience``: faults, manifest, supervisor, drill),
held against the JAX package's (``tests/test_resilience.py``, case by
case, without the serve, gang and L11-lint cases).

The fault grammar gives equal clauses and the registries fire on the
same hits; ``classify_error``, the degradations and the backoff
schedules equal the JAX package's on the same exception sequences, with
``torch.OutOfMemoryError`` as ``oom`` and a sticky CUDA error as
``fatal``; the atomic writes and the manifest keep their contracts; and
the fault drill recovers every site on the CPU with the ``.npz`` files
byte for byte the clean run's.
"""

import json
import os
import random
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.resilience import faults as jfaults
from dgen_tpu.resilience import supervisor as jsup
from dgen_tpu_torch.config import RunConfig
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.resilience import supervisor as tsup
from dgen_tpu_torch.resilience.drill import (
    DRILL_SPECS,
    DrillWorld,
    compare_run_dirs,
    run_drill,
    synth_world,
)
from dgen_tpu_torch.resilience.manifest import RunManifest, _part_year, verify_run_dir
from dgen_tpu_torch.resilience.supervisor import (
    FATAL,
    HOSTIO,
    OOM,
    TRANSIENT,
    RetryPolicy,
    Supervisor,
    classify_error,
    run_supervised,
)
from dgen_tpu_torch.utils.atomic import atomic_write, atomic_write_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the drill's world on the CPU: the smallest that fires every site (2
#: model years, 4 agents, no storage, the fewest candidates, a 5-year
#: cash-flow horizon)
N_AGENTS, END_YEAR = 4, 2016
FAST_POLICY = RetryPolicy(max_retries=3, backoff_base_s=0.001, min_agent_chunk=64)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small model years: beside
    the suite's other worker processes, more threads only contend (their
    serial seconds fell ~2.4x in a three-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world():
    w = synth_world(sizing_iters=4, device="cpu")
    return DrillWorld(make_population=w.make_population, device="cpu",
                      storage_enabled=False, sizing_iters=4, econ_years=5)


def _make_sim():
    w = _world()
    return w.runner(w.make_population(N_AGENTS), w.scenario(END_YEAR))


def _no_sleep(_s: float) -> None:
    pass


# ---------------------------------------------------------------------------
# fault spec grammar + registry
# ---------------------------------------------------------------------------

SPECS = ["ckpt_save@2; year_step@3x2:oom ;hostio_io", "export_torn@2:truncate",
         "bank_corrupt_row@3:corrupt;ingest_corrupt_row", "hostio_fetch x3:hang"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_grammar_equals_the_jax_package(spec):
    got = [(c.site, c.nth, c.times, c.kind) for c in faults.parse_spec(spec)]
    want = [(c.site, c.nth, c.times, c.kind) for c in jfaults.parse_spec(spec)]
    assert got == want
    assert faults.KINDS == jfaults.KINDS
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE
    assert faults.corrupt_rows() == jfaults.corrupt_rows()


def test_fault_spec_rejects_unknowns_and_unported_sites():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.parse_spec("not_a_site@1")
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse_spec("ckpt_save:explode")
    # every JAX site is either ported or refused with its roadmap item
    assert set(faults.SITES) | set(faults.UNPORTED_SITES) == set(jfaults.SITES)
    for site, item in faults.UNPORTED_SITES.items():
        with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
            faults.parse_spec(f"{site}@1")
        assert item.startswith("item ")


def test_registries_fire_on_the_same_hits():
    spec = "ckpt_save@2x2;year_step@1:oom;export_torn@3"
    trace = []
    for mod in (faults, jfaults):
        reg = mod.FaultRegistry.parse(spec)
        seen = []
        for site in ["ckpt_save"] * 4 + ["year_step"] * 2 + ["export_torn"] * 4:
            try:
                reg.hit(site)
                seen.append((site, None))
            except mod.FaultError as e:
                seen.append((site, e.kind, e.hit))
        trace.append((seen, {s: (reg.hits(s), reg.fired(s))
                             for s in ("ckpt_save", "year_step", "export_torn")}))
    assert trace[0] == trace[1]
    assert trace[0][1]["ckpt_save"] == (4, 2)


def test_fault_point_noop_without_registry():
    assert faults.active() is None
    faults.fault_point("ckpt_save")           # must not raise or count


def test_injected_context_restores_previous():
    with faults.injected("ckpt_save@1") as reg:
        assert faults.active() is reg
        with pytest.raises(faults.FaultError):
            faults.fault_point("ckpt_save")
    assert faults.active() is None


def test_simulated_oom_carries_both_markers():
    e = faults.SimulatedOOM("year_step", 3)
    assert "RESOURCE_EXHAUSTED" in str(e) and "CUDA out of memory" in str(e)
    assert classify_error(e) == OOM == jsup.classify_error(e)


def test_install_from_env_and_from_env_leave_the_spec_to_the_supervisor(monkeypatch):
    monkeypatch.setenv("DGEN_TPU_FAULTS", "ckpt_save@2")
    assert RunConfig.from_env().faults is None
    try:
        reg = faults.install_from_env()
        assert faults.active() is reg and reg.clauses[0].site == "ckpt_save"
    finally:
        faults.install(None)
    # the gang's sites are ported: a spec naming one installs
    monkeypatch.setenv("DGEN_TPU_FAULTS", "gang_barrier@1")
    try:
        reg = faults.install_from_env()
        assert faults.active() is reg and reg.clauses[0].site == "gang_barrier"
    finally:
        faults.install(None)
    # a site neither package knows is refused
    monkeypatch.setenv("DGEN_TPU_FAULTS", "no_such_site@1")
    with pytest.raises(ValueError, match="no_such_site"):
        faults.install_from_env()
    assert faults.active() is None


# ---------------------------------------------------------------------------
# classification + supervisor policies (no device work)
# ---------------------------------------------------------------------------

def _exceptions(mod):
    return [
        RuntimeError("RESOURCE_EXHAUSTED: oom"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        mod.FaultError("hostio_io", "error", 1),
        mod.FaultError("year_step", "error", 1),
        mod.FaultError("ckpt_save", "kill", 2),
        mod.SimulatedOOM("year_step", 2),
        OSError("disk"),
        ConnectionError("flake"),
        TimeoutError("slow"),
        ValueError("bug"),
        KeyError("k"),
        AssertionError("invariant"),
        NotImplementedError("later"),
        RuntimeError("???"),
    ]


def test_classify_error_equals_the_jax_package():
    got = [classify_error(e) for e in _exceptions(faults)]
    want = [jsup.classify_error(e) for e in _exceptions(jfaults)]
    assert got == want
    assert got[:4] == [OOM, OOM, HOSTIO, TRANSIENT]
    assert got[6:8] == [HOSTIO, TRANSIENT] and got[9] == FATAL


def test_classify_error_on_the_card():
    """A CUDA allocator OOM is ``oom`` by its type; a sticky CUDA error
    (the context is dead: no retry in the process can pass it) is
    ``fatal``."""
    assert classify_error(torch.OutOfMemoryError("allocation failed")) == OOM
    sticky = getattr(torch, "AcceleratorError", None)
    if sticky is not None:
        assert classify_error(sticky("CUDA error: an illegal memory access was "
                                     "encountered")) == FATAL
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered",
                "CUDA error: unspecified launch failure"):
        assert classify_error(RuntimeError(msg)) == FATAL, msg


def _policy(**kw):
    return dict(kw)


@pytest.mark.parametrize("case", ["oom_halves", "oom_whole_table", "oom_floor",
                                  "fatal", "hostio_fallback"])
def test_supervisor_degradations_equal_the_jax_package(case):
    """The same attempt function under both supervisors: the same chunks,
    retries, degradations and final config."""
    out = []
    for mod, fmod, cfg in ((tsup, faults, RunConfig), (jsup, jfaults, jcfg.RunConfig)):
        seen = []

        def attempt(ctx, fmod=fmod, seen=seen):
            rc = ctx.run_config
            seen.append((rc.agent_chunk, rc.async_host_io, ctx.resume))
            if case == "oom_halves" and (rc.agent_chunk or 10 ** 9) > 64:
                raise fmod.SimulatedOOM("year_step", len(seen))
            if case == "oom_whole_table" and rc.agent_chunk is None:
                raise fmod.SimulatedOOM("year_step", 1)
            if case == "oom_floor":
                raise fmod.SimulatedOOM("year_step", len(seen))
            if case == "fatal":
                raise ValueError("a bug, not weather")
            if case == "hostio_fallback" and rc.async_host_io is not False:
                raise fmod.FaultError("hostio_io", "error", len(seen))
            return rc.agent_chunk

        start = {"oom_halves": cfg(agent_chunk=256), "oom_floor": cfg(agent_chunk=32)
                 }.get(case, cfg())
        sup = mod.Supervisor(mod.RetryPolicy(max_retries=5, backoff_base_s=0.0,
                                             min_agent_chunk=32,
                                             hostio_failures_before_fallback=2),
                             sleep=_no_sleep)
        try:
            result, report = sup.run(attempt, start)
        except (fmod.FaultError, ValueError) as e:
            result, report = type(e).__name__, e.supervisor_report
        out.append((seen, result, report.retries, report.degradations,
                    report.retries_by_class, report.final_agent_chunk,
                    report.final_async_host_io))
    assert out[0] == out[1]
    expect = {"oom_halves": [256, 128, 64], "oom_whole_table": [None, 32],
              "oom_floor": [32], "fatal": [None], "hostio_fallback": [None, None, None]}
    assert [s[0] for s in out[0][0]] == expect[case]


def test_supervisor_backoff_equals_the_jax_package():
    for kw in (dict(backoff_base_s=0.1, backoff_factor=2.0, jitter_frac=0.2), {}):
        a = [RetryPolicy(**kw).backoff_s(k, random.Random(7)) for k in range(5)]
        b = [jsup.RetryPolicy(**kw).backoff_s(k, random.Random(7)) for k in range(5)]
        assert a == b
        assert all(x < y for x, y in zip(a, a[1:])), "must grow"
    assert RetryPolicy() == RetryPolicy(**{
        k: getattr(jsup.RetryPolicy(), k) for k in RetryPolicy.__dataclass_fields__})


def test_supervisor_releases_a_failed_attempt():
    """Nothing of a failed attempt stays alive before the next one: what
    its frames held is collected (on a card, its memory goes back)."""
    refs = []

    class Held:
        pass

    def attempt(ctx):
        held = Held()
        refs.append(weakref.ref(held))
        if ctx.attempt == 0:
            raise faults.SimulatedOOM("year_step", 1)
        assert refs[0]() is None, "the failed attempt's objects are alive"
        return "ok"

    sup = Supervisor(RetryPolicy(max_retries=2, backoff_base_s=0.0, min_agent_chunk=32),
                     sleep=_no_sleep)
    result, report = sup.run(attempt, RunConfig(agent_chunk=256))
    assert result == "ok" and report.retries == 1
    rec = report.attempts[0]
    assert rec.error_class == OOM and rec.wall_s >= 0.0
    assert rec.device_bytes_before is None and rec.device_bytes_after is None


# ---------------------------------------------------------------------------
# atomic writes + manifest
# ---------------------------------------------------------------------------

def test_atomic_write_publishes_or_nothing(tmp_path):
    p = str(tmp_path / "meta.json")
    atomic_write_json(p, {"ok": 1})
    with open(p) as f:
        assert json.load(f) == {"ok": 1}

    def boom(tmp):
        with open(tmp, "w") as f:
            f.write("partial")
        raise OSError("writer died")

    with pytest.raises(OSError):
        atomic_write(str(tmp_path / "new.json"), boom)
    assert not os.path.exists(tmp_path / "new.json")
    assert not os.path.exists(tmp_path / "new.json.tmp")
    with pytest.raises(OSError):
        atomic_write(p, boom)
    with open(p) as f:
        assert json.load(f) == {"ok": 1}


def test_atomic_write_fault_kinds(tmp_path):
    p = str(tmp_path / "a.json")
    with faults.injected("export_write@1"):
        with pytest.raises(faults.FaultError):
            atomic_write_json(p, {"x": 1})
    assert not os.path.exists(p) and not os.path.exists(p + ".tmp")
    with faults.injected("export_torn@1:truncate"):
        with pytest.raises(faults.FaultError):
            atomic_write_json(p, {"x": 1, "pad": "y" * 64})
    assert os.path.exists(p)
    with pytest.raises(json.JSONDecodeError):
        with open(p) as f:
            json.load(f)


def _make_manifested_dir(tmp_path):
    run_dir = str(tmp_path / "run")
    os.makedirs(os.path.join(run_dir, "agent_outputs"))
    m = RunManifest(run_dir)
    for year in (2014, 2016):
        rel = os.path.join("agent_outputs", f"year={year}.npz")

        def write(tmp, y=year):
            with open(tmp, "wb") as f:
                f.write(b"npz-bytes-%d" % y)

        atomic_write(os.path.join(run_dir, rel), write)
        m.record_artifact(year, rel)
        m.mark_year_complete(year)
    return run_dir, m


def test_manifest_verify_clean_and_truncated(tmp_path):
    run_dir, _ = _make_manifested_dir(tmp_path)
    rep = RunManifest(run_dir).verify()
    assert rep.ok and rep.years_complete == [2014, 2016]
    victim = os.path.join(run_dir, "agent_outputs", "year=2016.npz")
    with open(victim, "rb+") as f:
        f.truncate(4)
    rep = RunManifest(run_dir).verify()
    assert not rep.ok
    assert rep.corrupt == [os.path.join("agent_outputs", "year=2016.npz")]
    assert rep.years_complete == [2014]
    os.remove(victim)
    for name in ("year=2018.npz", "year=2014.npz.tmp"):
        with open(os.path.join(run_dir, "agent_outputs", name), "wb") as f:
            f.write(b"x")
    rep = RunManifest(run_dir).verify()
    assert rep.missing and rep.unrecorded and rep.stale_tmp
    assert [_part_year(n) for n in ("year=2018.npz", "year=2014.npz.tmp",
                                    "agents.npz", "year=.npz")] == [2018, 2014, None, None]


def test_manifest_complete_through_stops_at_gap(tmp_path):
    run_dir, m = _make_manifested_dir(tmp_path)
    years = [2014, 2016, 2018]
    assert m.complete_through(years) == 2016
    with open(os.path.join(run_dir, "agent_outputs", "year=2014.npz"), "rb+") as f:
        f.truncate(2)
    assert RunManifest(run_dir).complete_through(years) is None


def test_verify_cli_exit_codes(tmp_path):
    run_dir, _ = _make_manifested_dir(tmp_path)
    cmd = [sys.executable, "-m", "dgen_tpu_torch.resilience", "verify", run_dir]
    ok = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["ok"] is True
    with open(os.path.join(run_dir, "agent_outputs", "year=2016.npz"), "rb+") as f:
        f.truncate(3)
    bad = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=120)
    assert bad.returncode == 1 and json.loads(bad.stdout)["ok"] is False
    none = subprocess.run(cmd[:-1] + [str(tmp_path / "nothing")], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert none.returncode != 0


def test_cli_refuses_the_unported_drills(monkeypatch):
    from dgen_tpu_torch.resilience import __main__ as cli
    from dgen_tpu_torch.resilience import gangdrill

    # every drill of the JAX package's CLI is ported now (the fleet's in
    # tests/test_torch_fleet.py, the gang's in tests/test_torch_gang_drill.py):
    # none is refused, and --gang wins over the other drills as in JAX
    assert not hasattr(cli, "_UNPORTED_DRILLS")
    seen = []
    monkeypatch.setattr(gangdrill, "run_gang_drill",
                        lambda root, **kw: seen.append(kw) or {"ok": False})
    for args in (["--gang", "--gang-processes", "4"], ["--gang", "--serve-fleet"]):
        assert cli.main(["drill", *args, "--device", "cpu"]) == 1
    assert [kw["processes"] for kw in seen] == [4, 4]
    assert all(kw["end_year"] == 2018 and kw["device"] == "cpu" for kw in seen)


# ---------------------------------------------------------------------------
# the fault matrix: every run-path site fires, is recovered, and the files
# equal the uninterrupted run's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fault_matrix(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fault-matrix"))
    rec = run_drill(root, n_agents=N_AGENTS, end_year=END_YEAR, policy=FAST_POLICY,
                    world=_world())
    return root, rec


def test_fault_matrix_every_site_recovers(fault_matrix):
    _root, rec = fault_matrix
    assert {name for name, _ in DRILL_SPECS} == set(rec["sites"])
    for name, site in rec["sites"].items():
        assert site["fired"] >= 1, f"{name}: fault never fired"
        assert site["retries"] >= 1, f"{name}: supervisor never retried"
        assert site["verify_ok"], f"{name}: manifest verify failed"
        assert not site["npz"]["mismatched"], name
        assert site["npz"]["compared"] >= 4, name
        assert site["ok"], f"{name}: {site}"
    assert rec["ok"]


def test_fault_matrix_oom_degraded_and_stamped(fault_matrix):
    root, rec = fault_matrix
    oom = rec["sites"]["year_step_oom"]
    assert oom["degradations"] == ["oom: agent_chunk -> 64"]
    with open(os.path.join(root, "year_step_oom", "meta.json")) as f:
        meta = json.load(f)
    assert meta["supervisor"]["retries"] >= 1 and meta["supervisor"]["degradations"]
    with open(os.path.join(root, "year_step_oom", "manifest.json")) as f:
        man = json.load(f)
    assert any("degradation" in n for n in man["notes"])
    assert man["checkpoints"]
    assert "quarantine.json" in man["run_artifacts"]
    assert "agents.npz" not in man["run_artifacts"]   # no static frame asked for


def test_fault_matrix_clean_baseline_manifest(fault_matrix):
    root, _rec = fault_matrix
    assert all(r.ok for r in verify_run_dir(os.path.join(root, "clean")))
    with open(os.path.join(root, "clean", "meta.json")) as f:
        meta = json.load(f)
    assert meta["supervisor"]["retries"] == 0
    assert meta["quarantine"]["n_quarantined"] == 0


def test_compare_run_dirs_catches_one_value(fault_matrix, tmp_path):
    import shutil

    root, _ = fault_matrix
    d = str(tmp_path / "copy")
    shutil.copytree(os.path.join(root, "clean"), d)
    assert compare_run_dirs(os.path.join(root, "clean"), d)["ok"]
    p = os.path.join(d, "agent_outputs", "year=2016.npz")
    with np.load(p) as z:
        cols = {k: z[k].copy() for k in z.files}
    cols["npv"][0] += 0.5 * float(np.abs(cols["npv"]).max()) + 1.0
    from dgen_tpu_torch.utils.atomic import write_npz

    write_npz(p, cols)
    rec = compare_run_dirs(os.path.join(root, "clean"), d)
    assert rec["mismatched"] == [os.path.join("agent_outputs", "year=2016.npz")]
    assert not compare_run_dirs(os.path.join(root, "clean"), d, numeric=True)["ok"]


# ---------------------------------------------------------------------------
# resume semantics
# ---------------------------------------------------------------------------

def test_resume_collect_and_checkpoint_state_parity(tmp_path):
    from dgen_tpu_torch.io import checkpoint as ckpt

    make_sim = _make_sim()
    clean_dir = str(tmp_path / "clean")
    res_c, rep_c = run_supervised(make_sim, RunConfig(), run_dir=clean_dir,
                                  collect=True, policy=FAST_POLICY)
    assert rep_c.retries == 0
    faulted_dir = str(tmp_path / "faulted")
    with faults.injected("hostio_io@2") as reg:
        res_f, rep_f = run_supervised(make_sim, RunConfig(), run_dir=faulted_dir,
                                      collect=True, policy=FAST_POLICY)
    assert reg.fired("hostio_io") == 1 and rep_f.retries == 1
    assert res_f.years and res_f.years == res_c.years[-len(res_f.years):]
    off = len(res_c.years) - len(res_f.years)
    for k, v in res_f.agent.items():
        np.testing.assert_array_equal(v, res_c.agent[k][off:], err_msg=k)
    n = make_sim(RunConfig()).table.n_agents
    y_c, carry_c = ckpt.restore_year(os.path.join(clean_dir, "checkpoints"), n,
                                     device="cpu")
    y_f, carry_f = ckpt.restore_year(os.path.join(faulted_dir, "checkpoints"), n,
                                     device="cpu")
    assert y_c == y_f == res_c.years[-1]
    from dgen_tpu_torch.tree import leaf_paths

    lc, lf = leaf_paths(carry_c), leaf_paths(carry_f)
    assert lc.keys() == lf.keys()
    for k in lc:
        assert torch.equal(lc[k], lf[k]), k


def test_resume_restarts_when_nothing_durably_exported(tmp_path):
    import shutil

    make_sim = _make_sim()
    run_dir = str(tmp_path / "run")
    res, _ = run_supervised(make_sim, RunConfig(), run_dir=run_dir, collect=False,
                            policy=FAST_POLICY)
    for name in ("agent_outputs", "finance_series", "manifest.json"):
        p = os.path.join(run_dir, name)
        shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
    res2, _ = run_supervised(make_sim, RunConfig(), run_dir=run_dir, collect=False,
                             policy=FAST_POLICY, resume=True)
    assert res2.years == res.years
    assert all(r.ok for r in verify_run_dir(run_dir))
    assert RunManifest(run_dir).complete_through(res.years) == res.years[-1]


def test_run_supervised_uninstalls_own_registry(tmp_path):
    assert faults.active() is None
    _, rep = run_supervised(_make_sim(), RunConfig(faults="year_step@2"),
                            run_dir=str(tmp_path / "run"), collect=False,
                            policy=FAST_POLICY)
    assert rep.retries == 1
    assert faults.active() is None, "registry leaked past run_supervised"


def test_latest_valid_year_walks_past_corrupt(tmp_path):
    from dgen_tpu_torch.io import checkpoint as ckpt

    make_sim = _make_sim()
    sim = make_sim(RunConfig())
    cd = str(tmp_path / "ckpt")
    sim.run(collect=False, checkpoint_dir=cd)
    years = ckpt.valid_years(cd)
    assert years == sim.years and len(years) > 1
    n = sim.table.n_agents
    assert ckpt.latest_valid_year(cd, n, device="cpu") == years[-1]
    assert ckpt.latest_valid_year(cd, n, max_year=years[0], device="cpu") == years[0]
    # resume_year pins the re-entry
    res2 = make_sim(RunConfig()).run(collect=True, checkpoint_dir=cd, resume=True,
                                     resume_year=years[0])
    assert res2.years == sim.years[1:]
    with open(os.path.join(cd, str(years[-1]), "carry.npz"), "rb+") as fh:
        fh.truncate(1)
    assert ckpt.latest_valid_year(cd, n, device="cpu") == years[-2]


# ---------------------------------------------------------------------------
# the sweep's fault site
# ---------------------------------------------------------------------------

def test_sweep_scenario_fault_resumes_at_scenario_year(tmp_path):
    """Loop-mode sweep (tests/test_resilience.py's case): a death between
    scenarios is retried by the supervisor with resume; the re-entered
    sweep skips the completed scenario's years and runs the unstarted one
    bit for bit, and the surfaces it exported as it ran are the clean
    sweep's byte for byte."""
    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario
    from dgen_tpu_torch.sweep import SweepSimulation

    cfg = ScenarioConfig(name="t", start_year=2014, end_year=END_YEAR, anchor_years=(),
                         storage_enabled=False)
    pop = synth.generate_population(N_AGENTS, states=["DE", "CA"], seed=11,
                                    pad_multiple=N_AGENTS, device="cpu")
    inputs = scenario.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                     n_regions=pop.n_regions, device="cpu")

    def make_sweep():
        return SweepSimulation(pop.table, pop.profiles, pop.tariffs, [inputs, inputs], cfg,
                               RunConfig(sizing_iters=4), labels=["a", "b"],
                               max_vmap_scenarios=0, econ_years=5, device="cpu")

    assert all(g.mode == "loop" for g in make_sweep().plan.groups)
    clean_dir = str(tmp_path / "clean")
    clean = make_sweep().run(collect=True, run_dir=clean_dir)
    cd, run_dir = str(tmp_path / "ckpt"), str(tmp_path / "run")
    sweep = make_sweep()

    def attempt(ctx):
        return sweep.run(collect=True, checkpoint_dir=cd, resume=ctx.resume, run_dir=run_dir)

    with faults.injected("sweep_scenario@2") as reg:
        results, report = Supervisor(FAST_POLICY, sleep=_no_sleep).run(attempt, RunConfig())
    assert reg.fired("sweep_scenario") == 1 and report.retries == 1
    assert results.runs[0].years == []
    assert results.runs[1].years == clean.runs[1].years
    for k, v in results.runs[1].agent.items():
        np.testing.assert_array_equal(v, clean.runs[1].agent[k], err_msg=k)
    for label in ("a", "b"):
        for surface in ("agent_outputs", "finance_series"):
            sub = os.path.join(f"scenario={label}", surface)
            names = sorted(os.listdir(os.path.join(clean_dir, sub)))
            assert names == sorted(os.listdir(os.path.join(run_dir, sub)))
            for name in names:
                with open(os.path.join(clean_dir, sub, name), "rb") as f_a, \
                        open(os.path.join(run_dir, sub, name), "rb") as f_b:
                    assert f_a.read() == f_b.read(), (sub, name)
