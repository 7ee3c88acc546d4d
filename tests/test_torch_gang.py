"""The rank gang's pieces on the CPU, one for one with the non-slow tests
of tests/test_gang.py (:39-408): ``GangConfig`` (its checks and env, held
to the JAX package's), the registered fault sites, the shard-ledger merge
(``GangManifest``: frontier, epochs, verify, prune), the elastic walk,
the supervisor's state machine on stub ranks (``python -c`` stubs that
import no torch), the heartbeat paths, and a checkpoint written by two
gloo ranks restored by one process bit for bit.

Beyond them, the port's ``GangManifest`` is held to the JAX package's on
the same run directories (frontier, verify verdict, complete years,
epochs): directories of hand-built shard ledgers, and one written by a
real two-rank gang of the port's own ranks.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dgen_tpu.config import GangConfig as JGangConfig
from dgen_tpu.resilience import manifest as jman
from dgen_tpu_torch.config import GangConfig, RunConfig
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.resilience.gang import (
    GangCrashLoop,
    GangSupervisor,
    done_path,
    heartbeat_path,
)
from dgen_tpu_torch.resilience.manifest import (
    GangManifest,
    RunManifest,
    discover_shards,
    verify_run_dir,
)
from dgen_tpu_torch.resilience.supervisor import RetryPolicy

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# config and env
# ---------------------------------------------------------------------------

def test_gang_config_validation():
    cfg = GangConfig(n_processes=4, total_devices=4, shrink_plan=(2, 1))
    assert cfg.devices_for(4) == 1
    assert cfg.devices_for(2) == 2
    assert cfg.devices_for(3) == 1   # indivisible: the per-process value
    bad = (dict(n_processes=0), dict(n_processes=2, shrink_plan=(2,)),
           dict(n_processes=4, shrink_plan=(1, 2)), dict(n_processes=4, shrink_plan=(2, 2)),
           dict(n_processes=4, total_devices=4, shrink_plan=(3,)),
           dict(stall_timeout_s=0))
    for kw in bad:
        with pytest.raises(ValueError):
            GangConfig(**kw)
        with pytest.raises(ValueError):
            JGangConfig(**kw)
    with pytest.raises(ValueError, match="total_devices"):
        GangConfig(n_processes=4, total_devices=4, shrink_plan=(3,))
    with pytest.raises(ValueError, match="platform"):
        GangConfig(platform="tpu")
    # the JAX package's fields, each with the same default but the platform
    # (the port's ranks run on the card unless asked for the CPU)
    import dataclasses

    mine = {f.name: f.default for f in dataclasses.fields(GangConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JGangConfig)}
    assert set(mine) == set(theirs)
    assert {k for k in mine if mine[k] != theirs[k]} == {"platform"}
    assert mine["platform"] == "cuda"


def test_gang_config_from_env(monkeypatch):
    monkeypatch.setenv("DGEN_TPU_GANG_PROCESSES", "8")
    monkeypatch.setenv("DGEN_TPU_GANG_TOTAL_DEVICES", "8")
    monkeypatch.setenv("DGEN_TPU_GANG_SHRINK_PLAN", "4,2")
    monkeypatch.setenv("DGEN_TPU_GANG_STALL_TIMEOUT_S", "33")
    monkeypatch.setenv("DGEN_TPU_GANG_PLATFORM", "cpu")
    cfg = GangConfig.from_env()
    assert cfg.n_processes == 8
    assert cfg.shrink_plan == (4, 2)
    assert cfg.stall_timeout_s == 33.0
    assert cfg.devices_for(2) == 4
    assert cfg.platform == "cpu"
    j = JGangConfig.from_env()
    assert (j.n_processes, j.shrink_plan, j.stall_timeout_s, j.devices_for(2)) == \
        (cfg.n_processes, cfg.shrink_plan, cfg.stall_timeout_s, cfg.devices_for(2))
    assert GangConfig.from_env(n_processes=4, shrink_plan=(2,)).n_processes == 4


def test_async_io_default_on(monkeypatch):
    """Host I/O runs on the pipeline by default for a multi-rank run as
    for one process: one resolved decision, one kill switch."""
    monkeypatch.delenv("DGEN_TPU_ASYNC_IO", raising=False)
    rc = RunConfig()
    assert rc.async_io_enabled is True
    assert not hasattr(rc, "async_io_multiprocess_optin")
    monkeypatch.setenv("DGEN_TPU_ASYNC_IO", "0")
    assert RunConfig().async_io_enabled is False
    monkeypatch.delenv("DGEN_TPU_ASYNC_IO", raising=False)
    assert RunConfig(async_host_io=True).async_io_enabled
    assert not RunConfig(async_host_io=False).async_io_enabled


def test_gang_fault_sites_registered():
    from dgen_tpu.resilience import faults as jfaults

    for site in ("gang_worker_kill", "gang_heartbeat_stall", "gang_barrier"):
        assert site in faults.SITES and site in jfaults.SITES
    assert not faults.UNPORTED_SITES
    assert set(faults.SITES) == set(jfaults.SITES)
    spec = faults.parse_spec("gang_worker_kill@2:kill;gang_heartbeat_stall@4:hang")
    assert spec[0].site == "gang_worker_kill" and spec[0].kind == "kill"
    assert spec[1].nth == 4 and spec[1].kind == "hang"


# ---------------------------------------------------------------------------
# shard ledgers and the GangManifest merge
# ---------------------------------------------------------------------------

def _touch(run_dir, rel, data=b"x"):
    p = os.path.join(run_dir, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _shard_year(run_dir, shard, n_proc, year, complete=True):
    m = RunManifest(run_dir, shard=shard, n_processes=n_proc)
    rel = os.path.join("agent_outputs", f"year={year}-p{shard}.npz")
    _touch(run_dir, rel, f"{year}-{shard}".encode())
    m.record_artifact(year, rel)
    if complete:
        m.mark_year_complete(year)
    else:
        m.flush()
    return m


def _same_merge(run_dir, years):
    """The port's GangManifest and the JAX package's agree on the run
    directory: frontier (deep and shallow), complete years, each year's
    epoch, and the verify verdict."""
    mine, theirs = GangManifest(run_dir), jman.GangManifest(run_dir)
    assert sorted(mine.shards) == sorted(theirs.shards)
    for deep in (True, False):
        assert mine.frontier(years, deep=deep) == theirs.frontier(years, deep=deep)
    assert mine.complete_years() == theirs.complete_years()
    for y in years:
        assert mine.year_epoch(y) == theirs._year_epoch(y), y
    a, b = mine.verify(), theirs.verify()
    assert (a.ok, a.years_complete, sorted(a.missing), sorted(a.corrupt)) == \
        (b.ok, b.years_complete, sorted(b.missing), sorted(b.corrupt))
    return mine


def test_gang_frontier_requires_every_shard(tmp_path):
    run_dir = str(tmp_path)
    years = [2014, 2016, 2018]
    # both shards complete 2014; only shard 0 completes 2016
    for s in (0, 1):
        _shard_year(run_dir, s, 2, 2014)
    _shard_year(run_dir, 0, 2, 2016)
    assert discover_shards(run_dir) == [0, 1]
    assert _same_merge(run_dir, years).frontier(years) == 2014
    # shard 1 lands 2016: the frontier advances
    _shard_year(run_dir, 1, 2, 2016)
    assert _same_merge(run_dir, years).frontier(years) == 2016
    # recorded but not complete (a rank killed mid-export) holds it
    _shard_year(run_dir, 0, 2, 2018)
    _shard_year(run_dir, 1, 2, 2018, complete=False)
    assert _same_merge(run_dir, years).frontier(years) == 2016


def test_gang_frontier_none_means_restart_from_scratch(tmp_path):
    """No durably complete year (or no ledgers at all): frontier None, a
    relaunch from scratch; the resume plan prunes the dead attempt's
    partial artifacts so the restart starts clean."""
    run_dir = str(tmp_path / "run")
    years = [2014, 2016]
    sup = GangSupervisor(run_dir, years, config=GangConfig(platform=""),
                         gang_dir=str(tmp_path / "gang"))
    assert sup._resume_plan() is None       # no directory
    os.makedirs(run_dir)
    assert sup._resume_plan() is None       # no shard ledgers
    _shard_year(run_dir, 0, 2, 2014)        # half a gang's year only
    assert sup._resume_plan() is None
    assert not os.listdir(os.path.join(run_dir, "agent_outputs"))


def test_gang_frontier_elastic_epoch(tmp_path):
    """Years written after a P -> P' shrink are complete with the P'
    shards alone: each year is judged against its own writing epoch."""
    run_dir = str(tmp_path)
    years = [2014, 2016]
    for s in (0, 1, 2, 3):
        _shard_year(run_dir, s, 4, 2014)
    for s in (0, 1):
        _shard_year(run_dir, s, 2, 2016)
    gm = _same_merge(run_dir, years)
    assert gm.frontier(years) == 2016
    assert gm.year_epoch(2014) == (4, [0, 1, 2, 3])
    assert gm.year_epoch(2016) == (2, [0, 1])


def test_gang_manifest_verify_merged(tmp_path):
    run_dir = str(tmp_path)
    for s in (0, 1):
        _shard_year(run_dir, s, 2, 2014)
    rep = _same_merge(run_dir, [2014]).verify()
    assert rep.ok and rep.years_complete == [2014]
    assert not rep.unrecorded   # a peer's parts are not unrecorded
    # verify_run_dir routes a gang directory to the merged report
    reports = verify_run_dir(run_dir)
    assert len(reports) == 1 and reports[0].ok
    # one shard's artifact damaged: corrupt, and the year not complete
    p = os.path.join(run_dir, "agent_outputs", "year=2014-p1.npz")
    with open(p, "wb") as f:
        f.write(b"torn")
    rep = _same_merge(run_dir, [2014]).verify()
    assert not rep.ok and rep.corrupt
    assert rep.years_complete == []
    # a stray part no ledger holds shows in the sweep (advisory)
    _touch(run_dir, os.path.join("agent_outputs", "year=9-p9.npz"))
    rep = GangManifest(run_dir).verify()
    assert any("year=9" in u for u in rep.unrecorded)


def test_gang_prune_after_clears_dead_epoch(tmp_path):
    """A dead epoch's partial parts are pruned before a relaunch at
    another gang size: stale ``-p2``/``-p3`` parts would double rows and
    the mixed epoch stamps would wedge the merged completeness check."""
    run_dir = str(tmp_path)
    years = [2014, 2016]
    for s in range(4):
        _shard_year(run_dir, s, 4, 2014)
    # the P = 4 gang died mid-2016: two shards recorded (incomplete), one
    # landed unledgered (killed between rename and record)
    _shard_year(run_dir, 0, 4, 2016, complete=False)
    _shard_year(run_dir, 2, 4, 2016, complete=False)
    _touch(run_dir, os.path.join("agent_outputs", "year=2016-p3.npz"))
    gm = _same_merge(run_dir, years)
    assert gm.frontier(years) == 2014
    removed = gm.prune_after(2014)
    assert any("2016" in r for r in removed)
    names = os.listdir(os.path.join(run_dir, "agent_outputs"))
    assert all("year=2016" not in n for n in names)
    # a P' = 2 re-export of 2016 then completes cleanly
    for s in (0, 1):
        _shard_year(run_dir, s, 2, 2016)
    gm = _same_merge(run_dir, years)
    assert gm.frontier(years) == 2016
    assert gm.verify().ok
    # frontier None: everything goes
    gm.prune_after(None)
    assert GangManifest(run_dir).frontier(years) is None
    assert not os.listdir(os.path.join(run_dir, "agent_outputs"))


# ---------------------------------------------------------------------------
# elastic resume planning
# ---------------------------------------------------------------------------

def test_elastic_resume_year_walks_past_corrupt(tmp_path):
    from dgen_tpu_torch.io import checkpoint as ckpt
    from dgen_tpu_torch.models.simulation import SimCarry
    from dgen_tpu_torch.parallel import elastic

    n = 64
    cd = str(tmp_path / "ckpt")
    with ckpt.Writer(cd) as w:
        for y in (2014, 2016):
            w.save(y, SimCarry.zeros(n, "cpu"))
    assert elastic.resume_year_for(cd, n, None, device="cpu") is None
    # the frontier caps the resume even when newer checkpoints exist
    assert elastic.resume_year_for(cd, n, 2014, device="cpu") == 2014
    assert elastic.resume_year_for(cd, n, 2016, device="cpu") == 2016
    # the newest year damaged: the walk falls back to 2014
    step = os.path.join(cd, "2016")
    for root, _, files in os.walk(step):
        for f in files:
            p = os.path.join(root, f)
            if os.path.getsize(p) > 0:
                with open(p, "r+b") as fh:
                    fh.truncate(max(os.path.getsize(p) // 2, 1))
    assert elastic.resume_year_for(cd, n, 2016, device="cpu") == 2014


def test_elastic_validate_topology_names_fix():
    from dgen_tpu_torch.parallel import elastic
    from dgen_tpu_torch.parallel.mesh import RankTopology

    topo = RankTopology(hosts=2, devices=4, rank=0, local_rank=0,
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="pad_table"):
        elastic.validate_topology(topo.world_size + 1, topo)
    elastic.validate_topology(topo.world_size * 4, topo)   # divides


# ---------------------------------------------------------------------------
# the supervisor's state machine, on stub ranks that import no torch
# ---------------------------------------------------------------------------

_STUB = textwrap.dedent("""
    import json, os, sys, time
    gd = os.environ["DGEN_GANG_DIR"]
    i = os.environ["DGEN_PROCESS_ID"]

    def w(path, obj):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    assert "torch" not in sys.modules
    hb = os.path.join(gd, f"worker-{i}.hb.json")
    w(hb, {"t": time.time(), "phase": "boot"})
    mode = os.environ.get("STUB_MODE", "ok")
    if mode == "die":
        sys.exit(3)
    w(hb, {"t": time.time(), "year": 2014, "year_idx": 0})
    if mode == "stall":
        time.sleep(120)
    w(os.path.join(gd, f"worker-{i}.done.json"),
      {"process": int(i), "completed_through": 2016,
       "preempted": os.environ.get("STUB_PREEMPT") == "1"})
""")


def _stub_supervisor(tmp_path, env_for=None, **cfg_over):
    kw = dict(n_processes=2, platform="", poll_interval_s=0.05, boot_timeout_s=10.0,
              stall_timeout_s=0.8, restart_window_s=30.0)
    kw.update(cfg_over)
    return GangSupervisor(
        str(tmp_path / "run"), [2014, 2016],
        cmd_for=lambda i, n: [sys.executable, "-c", _STUB],
        config=GangConfig(**kw), policy=RetryPolicy(backoff_base_s=0.01),
        env_for=env_for, gang_dir=str(tmp_path / "gang"))


def test_stub_gang_clean_run(tmp_path):
    rep = _stub_supervisor(tmp_path).run()
    assert rep.succeeded and not rep.preempted
    assert rep.restarts == 0
    assert rep.completed_through == 2016
    assert rep.attempts[0].first_year_s is not None


def test_stub_gang_death_restarts_whole_gang(tmp_path):
    def env_for(i, attempt):
        if i == 1 and attempt == 0:
            return {"STUB_MODE": "die"}
        return None

    rep = _stub_supervisor(tmp_path, env_for=env_for).run()
    assert rep.succeeded and rep.restarts == 1
    a = rep.attempts[0]
    assert (a.outcome, a.reason, a.worker, a.exit_code) == ("died", "worker_exit", 1, 3)
    assert a.detect_s is not None and a.detect_s < 5.0 and a.teardown_s is not None
    assert rep.attempts[1].outcome == "complete"
    assert rep.recovery_wall_s > 0 and rep.relaunch_wall_s is not None


def test_stub_gang_stall_detected_by_heartbeat(tmp_path):
    """A rank that is alive but silent: only heartbeat staleness catches
    it, and the supervisor kills and relaunches the gang (before a
    year-over-year gap is measured the bound is boot_timeout_s)."""
    def env_for(i, attempt):
        if i == 0 and attempt == 0:
            return {"STUB_MODE": "stall"}
        return None

    rep = _stub_supervisor(tmp_path, env_for=env_for, boot_timeout_s=2.0).run()
    assert rep.succeeded and rep.restarts == 1
    assert rep.attempts[0].reason == "heartbeat_stall"
    assert rep.attempts[0].worker == 0


def test_stub_gang_crash_loop_breaker(tmp_path):
    sup = _stub_supervisor(tmp_path, env_for=lambda i, a: {"STUB_MODE": "die"},
                           max_restarts=1)
    with pytest.raises(GangCrashLoop) as exc:
        sup.run()
    rep = exc.value.gang_report
    assert not rep.succeeded
    assert rep.restarts >= 1
    assert all(a.outcome == "died" for a in rep.attempts)


def test_stub_gang_breaker_shrinks_then_succeeds(tmp_path):
    """The crash-loop breaker at P falls through to the shrink plan: the
    gang resumes at P' instead of dying."""
    def env_for(i, attempt):
        return {"STUB_MODE": "die"} if i == 1 else None

    rep = _stub_supervisor(tmp_path, env_for=env_for, max_restarts=1,
                           shrink_plan=(1,)).run()
    assert rep.succeeded
    assert rep.processes_initial == 2 and rep.processes_final == 1
    assert rep.shrinks and "P'=1" in rep.shrinks[0]


def test_stub_gang_preempted_stop(tmp_path):
    def env_for(i, attempt):
        return {"STUB_PREEMPT": "1"} if i == 0 else None

    rep = _stub_supervisor(tmp_path, env_for=env_for).run()
    assert rep.succeeded and rep.preempted


def test_heartbeat_and_done_paths(tmp_path):
    from dgen_tpu.resilience import gang as jgang
    from dgen_tpu_torch.resilience.gang import read_json, write_heartbeat

    hb = heartbeat_path(str(tmp_path), 3)
    assert hb == jgang.heartbeat_path(str(tmp_path), 3)
    write_heartbeat(hb, year=2016, pid=123)
    doc = read_json(hb)
    assert doc["year"] == 2016 and doc["pid"] == 123
    assert done_path(str(tmp_path), 3) == jgang.done_path(str(tmp_path), 3)
    assert done_path(str(tmp_path), 3).endswith("worker-3.done.json")
    assert read_json(done_path(str(tmp_path), 3)) is None


# ---------------------------------------------------------------------------
# resharded restore: two ranks' checkpoint parts, one process, bit for bit
# ---------------------------------------------------------------------------

def test_resharded_restore_2to1_bitexact(tmp_path):
    """A checkpoint written by a two-rank gloo gang (one part a rank, the
    rows' agent ids beside it) restores bit for bit in one process and
    onto another split of the rows: the resharded restore the gang's
    P -> P' relaunch takes (``parallel.elastic``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ckpt_dir = str(tmp_path / "ckpt")
    n = 64

    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        from dgen_tpu_torch.io import checkpoint as ckpt
        from dgen_tpu_torch.models.simulation import SimCarry
        from dgen_tpu_torch.tree import leaf_paths

        pid = int(sys.argv[1])
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                                world_size=2, rank=pid)
        half = {n} // 2
        # each rank holds every other agent, in reverse order
        ids = np.arange({n}, dtype=np.int64)[pid::2][::-1].copy()
        names = sorted(leaf_paths(SimCarry.zeros(half, "cpu")))

        full = {{k: torch.from_numpy((np.arange({n}, dtype=np.float64) * (j + 1) + j)
                                     .astype(np.float32)) for j, k in enumerate(names)}}
        carry = SimCarry.zeros(half, "cpu")
        for k, leaf in leaf_paths(carry).items():
            leaf.copy_(full[k][torch.from_numpy(ids)])
        ckpt.Writer({ckpt_dir!r}, rows=ids, shard=(pid, 2)).save(2014, carry)
        dist.barrier()
        print(f"P{{pid}}_SAVED")
        dist.destroy_process_group()
    """)
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "PYTHONPATH": REPO_ROOT,
           "OMP_NUM_THREADS": "1"}
    logs = [open(tmp_path / f"p{pid}.log", "w+") for pid in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)], stdout=logs[pid],
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO_ROOT)
             for pid in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for pid, p in enumerate(procs):
        out = (tmp_path / f"p{pid}.log").read_text()
        assert p.returncode == 0, f"p{pid}: {out[-3000:]}"
        assert f"P{pid}_SAVED" in out

    from dgen_tpu_torch.models.simulation import SimCarry
    from dgen_tpu_torch.parallel import elastic
    from dgen_tpu_torch.tree import leaf_paths

    names = sorted(leaf_paths(SimCarry.zeros(1, "cpu")))
    want = {k: (np.arange(n, dtype=np.float64) * (j + 1) + j).astype(np.float32)
            for j, k in enumerate(names)}
    assert elastic.is_sharded(ckpt_dir, 2014)
    # one process, rows in agent-id order
    ids = np.arange(n, dtype=np.int64)
    year, carry = elastic.restore_resharded(ckpt_dir, n, topo=None, device="cpu", rows=ids)
    assert year == 2014
    for k, v in leaf_paths(carry).items():
        assert v.numpy().tobytes() == want[k].tobytes(), k
    # two ranks of another split (contiguous halves)
    from dgen_tpu_torch.parallel.mesh import RankTopology

    for r in (0, 1):
        topo = RankTopology(hosts=1, devices=2, rank=r, local_rank=r,
                            device=torch.device("cpu"))
        rows = ids[r * (n // 2):(r + 1) * (n // 2)]
        _, carry = elastic.restore_resharded(ckpt_dir, n, topo=topo, device="cpu",
                                             rows=rows)
        for k, v in leaf_paths(carry).items():
            assert v.numpy().tobytes() == want[k][rows].tobytes(), (r, k)


# ---------------------------------------------------------------------------
# the port's GangManifest against the JAX package's, on a real gang's run
# ---------------------------------------------------------------------------

def test_gang_manifest_equals_jax_on_a_real_two_rank_gang(tmp_path):
    """A two-rank gang of the port's ranks (gloo, 48 agents, 2014-2016)
    writes shard ledgers, parts, checkpoints and the coordinator ledger;
    the port's GangManifest and the JAX package's read the same frontier,
    epochs, complete years and verdict, before and after one part is
    torn."""
    run_dir = str(tmp_path / "run")
    sup = GangSupervisor(run_dir, [2014, 2016],
                         config=GangConfig(n_processes=2, platform="cpu",
                                           poll_interval_s=0.1),
                         policy=RetryPolicy(backoff_base_s=0.01),
                         worker_env={"DGEN_AGENTS": "48", "DGEN_END_YEAR": "2016",
                                     "DGEN_GANG_ECON_YEARS": "5", "OMP_NUM_THREADS": "1"},
                         gang_dir=str(tmp_path / "gang"))
    rep = sup.run()
    assert rep.succeeded and rep.restarts == 0 and rep.completed_through == 2016
    assert len(rep.done) == 2 and not any(d["imports_jax"] for d in rep.done)
    years = [2014, 2016]
    gm = _same_merge(run_dir, years)
    assert gm.frontier(years) == 2016 and gm.year_epoch(2016) == (2, [0, 1])
    assert gm.verify().ok and not gm.verify().unrecorded
    # the coordinator ledger: the parts of each checkpointed year, hashed
    with open(os.path.join(run_dir, "manifest-gang.json")) as f:
        doc = json.load(f)
    assert sorted(doc["checkpoint_parts"]) == ["2014", "2016"]
    assert all(len(v) == 2 for v in doc["checkpoint_parts"].values())
    assert doc["notes"] and "restarts=0" in doc["notes"][-1]
    # a torn part of 2016: both packages pull the frontier back to 2014
    part = os.path.join(run_dir, "agent_outputs", "year=2016-p1.npz")
    with open(part, "r+b") as f:
        f.truncate(os.path.getsize(part) // 2)
    gm = _same_merge(run_dir, years)
    assert gm.frontier(years) == 2014 and not gm.verify().ok
