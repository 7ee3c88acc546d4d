"""The gang drill: a multi-rank run survives a rank's death, a rank's
stall and a permanent P -> P' shrink, with exports equal to an
uninterrupted gang's bit for bit (port of
``dgen_tpu/resilience/gangdrill.py``).

``python -m dgen_tpu_torch.resilience drill --gang`` runs it (``--device
cpu`` over gloo; on the card the ranks share it over gloo, or take a card
each over NCCL where the host has enough). Rounds:

* **baseline**: a clean P-rank gang to completion (the comparison
  oracle; it also shows that the supervisor adds no restart to a healthy
  gang);
* **kill**: one rank killed mid-year (``gang_worker_kill@2:kill``,
  ``os._exit`` with collectives in flight). The supervisor must tear the
  whole gang down, relaunch it from the merged manifest frontier and
  finish with every rank's part byte for byte the baseline's and a clean
  merged verify;
* **stall**: one rank hangs instead of dying
  (``gang_heartbeat_stall@4:hang``); only heartbeat staleness can catch
  it. The same recovery contract. (It needs >= 3 model years, so that the
  stall lands after the first years; skipped otherwise.)
* **elastic**: the gang is stopped after its first year through the
  synchronized stop barrier (``DGEN_GANG_STOP_AFTER`` on rank 0 only: the
  other ranks learn of the stop through the barrier), then resumed at
  P' < P ranks: the checkpoint parts written at P restore onto the P'
  ranks' rows by agent id (``parallel.elastic``). The year before the
  stop compares part for part, byte for byte; the resumed years (split
  over P' ranks) row for row by ``agent_id``, bit for bit: a rank's rows
  give the same bits whatever the world size (``parallel``).

The port compares every round exactly: the JAX package allows the
resumed years of its elastic round a float envelope (rtol 5e-5, atol
1e-3), because its per-process programs re-associate sums when the
process layout changes; the port's sums do not.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from dgen_tpu_torch.config import GangConfig, ScenarioConfig
from dgen_tpu_torch.resilience.gang import GangSupervisor
from dgen_tpu_torch.resilience.manifest import PART_SUFFIX, verify_run_dir
from dgen_tpu_torch.resilience.supervisor import RetryPolicy

logger = logging.getLogger(__name__)

#: per-rank surfaces the gang exports (state_hourly is off in the drill's
#: world)
GANG_SURFACES = ("agent_outputs", "finance_series")


def _parts_by_year(run_dir: str, surface: str) -> Dict[int, List[str]]:
    d = os.path.join(run_dir, surface)
    out: Dict[int, List[str]] = {}
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not name.endswith(PART_SUFFIX):
            continue
        year = int(name.split("=")[1].split("-")[0].split(".")[0])
        out.setdefault(year, []).append(name)
    return out


def _read_rows(paths: List[str]) -> Dict[str, np.ndarray]:
    """The parts' columns concatenated and sorted by agent id."""
    cols: Dict[str, list] = {}
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            for k in z.files:
                cols.setdefault(k, []).append(z[k])
    out = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.argsort(out["agent_id"], kind="stable")
    return {k: v[order] for k, v in out.items()}


def compare_gang_run_dirs(baseline: str, other: str) -> Dict[str, object]:
    """Compare two gang run directories surface by surface, year by year.
    Years whose part sets match compare byte for byte; years split
    otherwise over the ranks (or whose bytes differ) compare row for row
    after aligning on ``agent_id``, every value bit for bit."""
    rec: Dict[str, object] = {"mismatched": [], "year_mismatch": [], "compared": 0,
                              "row_compared_years": []}
    for surface in GANG_SURFACES:
        a, b = _parts_by_year(baseline, surface), _parts_by_year(other, surface)
        if set(a) != set(b):
            rec["year_mismatch"].append(f"{surface}: {sorted(a)} vs {sorted(b)}")
            continue
        for year in sorted(a):
            rec["compared"] += 1
            pa = [os.path.join(baseline, surface, n) for n in a[year]]
            pb = [os.path.join(other, surface, n) for n in b[year]]
            if a[year] == b[year]:
                same = True
                for x, y in zip(pa, pb):
                    with open(x, "rb") as fx, open(y, "rb") as fy:
                        same = same and fx.read() == fy.read()
                if same:
                    continue
            da, db = _read_rows(pa), _read_rows(pb)
            rec["row_compared_years"].append(f"{surface}/{year}")
            try:
                if sorted(da) != sorted(db) or len(da["agent_id"]) != len(db["agent_id"]):
                    raise AssertionError("shape or columns differ")
                for col in sorted(da):
                    va, vb = da[col], db[col]
                    if va.shape != vb.shape or va.tobytes() != vb.tobytes():
                        raise AssertionError(col)
            except AssertionError as e:
                rec["mismatched"].append(f"{surface}/{year}: {e}")
    rec["ok"] = not (rec["mismatched"] or rec["year_mismatch"])
    return rec


def _checkpoint_bitexact(ckpt_a: str, ckpt_b: str, year: int, agent_ids) -> bool:
    """Whether two checkpoint directories hold the same carry bits at
    ``year``, each restored onto ``agent_ids`` by id (the topology-free
    path every resharded resume takes), so a year written by P ranks
    compares with any other layout's."""
    from dgen_tpu_torch.io import checkpoint as ckpt
    from dgen_tpu_torch.tree import leaf_paths

    ids = np.asarray(agent_ids, np.int64)

    def raw(d):
        _, carry = ckpt.restore_year(d, len(ids), int(year), device="cpu", rows=ids)
        return {k: v.numpy() for k, v in leaf_paths(carry).items()}

    la, lb = raw(ckpt_a), raw(ckpt_b)
    return sorted(la) == sorted(lb) and all(
        la[k].tobytes() == lb[k].tobytes() for k in la)


def _agent_ids(run_dir: str) -> Optional[np.ndarray]:
    """The real agent ids of a gang run (its first year's parts)."""
    parts = _parts_by_year(run_dir, "agent_outputs")
    if not parts:
        return None
    first = min(parts)
    return _read_rows([os.path.join(run_dir, "agent_outputs", n)
                       for n in parts[first]])["agent_id"]


def _gang(run_dir: str, config: GangConfig, years: List[int],
          worker_env: Dict[str, str], env_for=None, gang_dir: Optional[str] = None,
          seed: int = 0) -> GangSupervisor:
    return GangSupervisor(run_dir, years, config=config,
                          policy=RetryPolicy(backoff_base_s=0.05), env_for=env_for,
                          worker_env=worker_env, gang_dir=gang_dir, seed=seed)


def _platform(device: str) -> str:
    from dgen_tpu_torch.config import resolve_device

    return resolve_device(device).type


def run_gang_drill(
    root: str,
    *,
    processes: int = 4,
    shrink_to: int = 2,
    total_devices: Optional[int] = None,
    agents: int = 96,
    end_year: int = 2018,
    sizing_iters: int = 6,
    stall: bool = True,
    stall_timeout_s: float = 25.0,
    device: str = "cuda",
    threads: int = 2,
    world_env: Optional[Dict[str, str]] = None,
    kill_hit: int = 2,
) -> Dict[str, object]:
    """Run the gang fault matrix under ``root`` and return the drill
    record (``ok``, and each round's restarts, walls and comparisons).

    ``device``: the ranks' (default the card; raises without one).
    ``threads``: every rank's intra-op threads (``OMP_NUM_THREADS``; on the
    CPU a parallel reduction can move the last bit with the count).
    ``world_env``: extra rank env selecting the world (``DGEN_PRESET``,
    ``DGEN_GANG_WORLD``, ...; default the small synthetic population of
    ``agents`` agents). ``kill_hit``: the export at which the kill round's
    rank dies (2: the second model year's). ``stall=False`` and
    ``shrink_to=0`` skip those rounds."""
    platform = _platform(device)
    total = total_devices or processes
    scen = ScenarioConfig(name="gang", start_year=2014, end_year=end_year,
                          anchor_years=())
    years = [int(y) for y in scen.model_years]
    worker_env = {"DGEN_AGENTS": str(agents), "DGEN_END_YEAR": str(end_year),
                  "DGEN_GANG_SIZING_ITERS": str(sizing_iters),
                  "OMP_NUM_THREADS": str(threads), **(world_env or {})}
    base_cfg = GangConfig(n_processes=processes, total_devices=total, platform=platform,
                          stall_timeout_s=120.0, max_restarts=3, restart_window_s=600.0)
    rounds: Dict[str, dict] = {}
    ok = True

    def _round(name: str, run_dir: str, report, *, compare: bool = True,
               want_restarts: int = 0, t0: float = 0.0) -> dict:
        verify_ok = all(r.ok for r in verify_run_dir(run_dir))
        cmp_rec = (compare_gang_run_dirs(os.path.join(root, "baseline"), run_dir)
                   if compare else {"ok": True, "compared": 0})
        rec = {
            "restarts": report.restarts,
            "recovery_wall_s": round(report.recovery_wall_s, 3),
            "relaunch_wall_s": report.relaunch_wall_s,
            "attempts": [{"outcome": a.outcome, "reason": a.reason, "worker": a.worker,
                          "exit_code": a.exit_code, "wall_s": round(a.wall_s, 3),
                          "detect_s": a.detect_s, "teardown_s": a.teardown_s,
                          "first_year_s": a.first_year_s}
                         for a in report.attempts],
            "shrinks": report.shrinks,
            "completed_through": report.completed_through,
            "card_free_before": report.card_free_before,
            "card_free_relaunch": report.card_free_relaunch,
            "ranks": [{k: d.get(k) for k in ("process", "agents", "rows", "agent_chunk",
                                             "max_memory_allocated", "memory_budget_bytes",
                                             "card_share_bytes", "resumed_after",
                                             "years_run", "run_s", "imports_jax",
                                             "imports_dgen_tpu")}
                      for d in report.done],
            "parts": {"compared": cmp_rec.get("compared"),
                      "mismatched": cmp_rec.get("mismatched", []),
                      "year_mismatch": cmp_rec.get("year_mismatch", []),
                      "row_compared_years": cmp_rec.get("row_compared_years", [])},
            "verify_ok": verify_ok,
            "drill_wall_s": round(time.perf_counter() - t0, 3),
            "ok": bool(report.succeeded and verify_ok and cmp_rec["ok"]
                       and report.restarts >= want_restarts
                       and not any(d.get("imports_jax") or d.get("imports_dgen_tpu")
                                   for d in report.done)),
        }
        logger.info("gang drill %s: %s (restarts=%d)", name,
                    "ok" if rec["ok"] else "FAILED", report.restarts)
        return rec

    # --- baseline: a clean P-rank gang ---
    t0 = time.perf_counter()
    base_dir = os.path.join(root, "baseline")
    rep = _gang(base_dir, base_cfg, years, worker_env).run()
    rounds["baseline"] = _round("baseline", base_dir, rep, compare=False, t0=t0)
    rounds["baseline"]["ok"] = bool(rounds["baseline"]["ok"] and rep.restarts == 0
                                    and not rep.preempted)
    ok = ok and rounds["baseline"]["ok"]

    # --- kill: one rank killed mid-year ---
    t0 = time.perf_counter()
    kill_dir = os.path.join(root, "kill")
    kill_rank = min(2, processes - 1)

    def kill_env(i: int, attempt: int):
        if i == kill_rank and attempt == 0:
            return {"DGEN_TPU_FAULTS": f"gang_worker_kill@{kill_hit}:kill"}
        return None

    rep = _gang(kill_dir, base_cfg, years, worker_env, env_for=kill_env,
                seed=1).run()
    rounds["kill"] = _round("kill", kill_dir, rep, want_restarts=1, t0=t0)
    ok = ok and rounds["kill"]["ok"]

    # --- stall: one rank hangs; only heartbeat staleness catches it (armed
    # at the 4th heartbeat, the boot's and three years', so it needs >= 3
    # model years) ---
    if stall and len(years) >= 3:
        t0 = time.perf_counter()
        stall_dir = os.path.join(root, "stall")
        stall_cfg = GangConfig(n_processes=processes, total_devices=total,
                               platform=platform, stall_timeout_s=stall_timeout_s,
                               max_restarts=3, restart_window_s=600.0)

        def stall_env(i: int, attempt: int):
            if i == min(1, processes - 1) and attempt == 0:
                return {"DGEN_TPU_FAULTS": "gang_heartbeat_stall@4:hang",
                        "DGEN_TPU_FAULT_HANG_S": "600"}
            return None

        rep = _gang(stall_dir, stall_cfg, years, worker_env, env_for=stall_env,
                    seed=2).run()
        rounds["stall"] = _round("stall", stall_dir, rep, want_restarts=1, t0=t0)
        rounds["stall"]["ok"] = bool(rounds["stall"]["ok"] and any(
            a.reason == "heartbeat_stall" for a in rep.attempts))
        ok = ok and rounds["stall"]["ok"]

    # --- elastic: the synchronized stop after year 1, resumed at P' < P ---
    if shrink_to:
        t0 = time.perf_counter()
        el_dir = os.path.join(root, "elastic")

        def stop_env(i: int, attempt: int):
            # rank 0 only: the others must learn of the stop through the
            # barrier (the synchronized emergency checkpoint)
            if i == 0 and attempt == 0:
                return {"DGEN_GANG_STOP_AFTER": str(years[0])}
            return None

        rep_a = _gang(el_dir, base_cfg, years, worker_env, env_for=stop_env, seed=3).run()
        shrunk_cfg = GangConfig(n_processes=shrink_to, total_devices=total,
                                platform=platform, stall_timeout_s=120.0, max_restarts=3,
                                restart_window_s=600.0)
        rep_b = _gang(el_dir, shrunk_cfg, years, worker_env, seed=4).run()
        # the carry the P' gang resumed from equals the baseline's at the
        # same year bit for bit
        ids = _agent_ids(el_dir)
        restore_exact = ids is not None and _checkpoint_bitexact(
            os.path.join(root, "baseline", "checkpoints"),
            os.path.join(el_dir, "checkpoints"), years[0], ids)
        rounds["elastic"] = _round("elastic", el_dir, rep_b, t0=t0)
        rounds["elastic"]["stopped_through"] = rep_a.completed_through
        rounds["elastic"]["restore_bitexact"] = restore_exact
        rounds["elastic"]["ok"] = bool(
            rounds["elastic"]["ok"] and rep_a.preempted
            and rep_a.completed_through == years[0] and not rep_b.preempted
            and restore_exact and rounds["elastic"]["parts"]["row_compared_years"])
        ok = ok and rounds["elastic"]["ok"]

    return {
        "ok": ok, "processes": processes, "shrink_to": shrink_to, "total_devices": total,
        "agents": agents, "years": years, "device": platform,
        "restarts_total": sum(r["restarts"] for r in rounds.values()),
        "recovery_wall_s_total": round(sum(r["recovery_wall_s"] for r in rounds.values()),
                                       3),
        "rounds": rounds,
    }

