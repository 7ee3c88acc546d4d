"""The scaling harness (port of ``tools/bench_scale.py``): agent-years a
second of the national year step against the number of ranks, weak and
strong, a 2-D grid parity point and the gang drill at size.

    python -m dgen_tpu_torch.tools.bench_scale [--device cpu]

Protocol (the JAX package's, with a rank where it has a device):

* **weak scaling**: fixed rows a rank, the rank count grows; ideal
  hardware holds agent-years/s a rank flat;
* **strong scaling**: a fixed table, the rank count grows; ideal hardware
  scales agent-years/s linearly;
* tables come from the state-stratified national generator
  (:mod:`dgen_tpu_torch.models.synth`), ``tariff_mix="nem"`` by default;
* a point of one rank runs in this process; a point of D ranks runs D
  rank processes of this module (``--rank-point``) on a localhost
  rendezvous, the ``(1, D)`` grid, each holding its state-partitioned
  shard (``Simulation(ranks=)``), its wall the slowest rank's; one 2-D
  ``(2, D/2)`` point must give the flat point's national sums within
  2e-5 relative;
* points at or above ``BIG_ROWS`` measure one model year; smaller points
  run ``YEARS`` model years and report the carry years' rate;
* the gang drill reruns the drill's world under the
  :class:`~dgen_tpu_torch.resilience.gang.GangSupervisor` with rank 1
  killed in its second year: the gang must resume from the merged
  manifest frontier and the merged manifest verify clean.

Ranks take a card each where the host has enough, and share the cards
otherwise (over gloo; each rank budgets its chunk against its share of
its card). On a machine with fewer cards than ranks the points of more
than one rank measure the partition and the collectives on shared
cards, not a scaling curve, and the record says so (``scaling_claim``):
no scaling figure comes from such a machine.

Results stream into the output JSON after every point (temp file and
rename), so a cut run keeps what it measured. Env knobs (the JAX
package's names)::

    DGEN_TPU_BENCH_SCALE_DEVICES      "1,2,4"     rank counts
    DGEN_TPU_BENCH_SCALE_WEAK_PER_DEV 65536       rows a rank (0 = skip)
    DGEN_TPU_BENCH_SCALE_STRONG       "1048576"   tables ("" = skip)
    DGEN_TPU_BENCH_SCALE_YEARS        2           model years (year_step=2)
    DGEN_TPU_BENCH_SCALE_BIG_ROWS     4000000     one-year protocol at/above
    DGEN_TPU_BENCH_SCALE_CHUNK        0           agent_chunk rows a rank
                                                  (0: the automatic chunk)
    DGEN_TPU_BENCH_SCALE_TARIFF_MIX   nem         nem | mixed
    DGEN_TPU_BENCH_SCALE_CLUSTER      0           RunConfig.cluster_tariffs
    DGEN_TPU_BENCH_SCALE_SIZING_ITERS 4
    DGEN_TPU_BENCH_SCALE_ECON_YEARS   8
    DGEN_TPU_BENCH_SCALE_MESH2D       1           2-D parity point on/off
    DGEN_TPU_BENCH_SCALE_DRILL        1048576     drill rows (0 = skip)
    DGEN_TPU_BENCH_SCALE_DRILL_PROCS  2           gang ranks
    DGEN_TPU_BENCH_SCALE_OUT          SCALE_torch_r01.json
    DGEN_TPU_BENCH_SCALE_BUDGET_S     21600       wall budget
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

_T0 = time.time()
START_YEAR = 2014
#: the flat and 2-D grids' national sums must agree within this
MESH2D_RTOL = 2e-5
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def _env_list(name: str, default: str):
    raw = os.environ.get(name, default).strip()
    return [int(x) for x in raw.split(",") if x.strip()]


def knobs() -> dict:
    """The env knobs (module docstring), read at call time."""
    return dict(
        devices=_env_list("DGEN_TPU_BENCH_SCALE_DEVICES", "1,2,4"),
        weak_per_dev=_env_int("DGEN_TPU_BENCH_SCALE_WEAK_PER_DEV", 65536),
        strong=_env_list("DGEN_TPU_BENCH_SCALE_STRONG", "1048576"),
        years=_env_int("DGEN_TPU_BENCH_SCALE_YEARS", 2),
        big_rows=_env_int("DGEN_TPU_BENCH_SCALE_BIG_ROWS", 4_000_000),
        chunk=_env_int("DGEN_TPU_BENCH_SCALE_CHUNK", 0),
        tariff_mix=os.environ.get("DGEN_TPU_BENCH_SCALE_TARIFF_MIX", "nem"),
        cluster=_env_int("DGEN_TPU_BENCH_SCALE_CLUSTER", 0),
        sizing_iters=_env_int("DGEN_TPU_BENCH_SCALE_SIZING_ITERS", 4),
        econ_years=_env_int("DGEN_TPU_BENCH_SCALE_ECON_YEARS", 8),
        mesh2d=_env_int("DGEN_TPU_BENCH_SCALE_MESH2D", 1),
        drill=_env_int("DGEN_TPU_BENCH_SCALE_DRILL", 1_048_576),
        drill_procs=_env_int("DGEN_TPU_BENCH_SCALE_DRILL_PROCS", 2),
        out=os.environ.get("DGEN_TPU_BENCH_SCALE_OUT", "SCALE_torch_r01.json"),
        budget_s=float(os.environ.get("DGEN_TPU_BENCH_SCALE_BUDGET_S", "21600")),
    )


def _card_count(device: str) -> int:
    import torch

    return torch.cuda.device_count() if device == "cuda" else 0


def measure(k: dict, n_agents: int, years: int, device, ranks=None) -> dict:
    """One rank's (or one process's) share of a point: the national world
    generated, the Simulation built on this rank's shard, ``years`` model
    years stepped; each year's wall (ending in the card's sync) and the
    national sums summed over the ranks."""
    import numpy as np
    import torch

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.models import synth as national
    from dgen_tpu_torch.models.simulation import Simulation

    cfg = ScenarioConfig(name="scale", start_year=START_YEAR,
                         end_year=START_YEAR + 2 * (years - 1), anchor_years=())
    spec = national.NationalSpec(n_agents=n_agents, seed=0, tariff_mix=k["tariff_mix"])
    t0 = time.time()
    world = national.generate_world(spec, device=device)
    gen_s = time.time() - t0
    inputs = scen.uniform_inputs(cfg, n_groups=world.table.n_groups,
                                 n_regions=spec.n_regions, device=device)
    t0 = time.time()
    sim = Simulation(world.table, world.profiles, world.tariffs, inputs, cfg,
                     RunConfig(sizing_iters=k["sizing_iters"], agent_chunk=k["chunk"] or None,
                               cluster_tariffs=bool(k["cluster"])),
                     econ_years=k["econ_years"], device=device, ranks=ranks)
    build_s = time.time() - t0
    del world
    mask = sim.table.mask
    carry = sim.init_carry()
    walls, sums = [], []
    for yi in range(len(cfg.model_years)):
        t0 = time.time()
        carry, outs = sim.step(carry, yi, yi == 0)
        sim._sync()
        walls.append(time.time() - t0)
        s = torch.stack([(outs.number_of_adopters * mask).sum(),
                         (outs.system_kw_cum * mask).sum()]).to(torch.float64)
        if sim.ranks is not None:
            s = sim.ranks.all_reduce(s)
        sums.append(s.cpu().numpy().tolist())
    rec = {"generate_s": round(gen_s, 3), "build_s": round(build_s, 3),
           "year_s": [round(w, 4) for w in walls], "sums": sums,
           "rows": int(sim.table.n_agents), "agent_chunk": sim._agent_chunk,
           "agents": int((np.asarray(sim.host_mask) > 0).sum()),
           "max_memory_allocated": (int(torch.cuda.max_memory_allocated(sim.device))
                                    if sim.device.type == "cuda" else None)}
    del sim, carry, outs
    gc.collect()
    return rec


def _spawn_point(k: dict, n_agents: int, n_ranks: int, grid, years: int,
                 device: str, timeout_s: float) -> list:
    """The point's ``n_ranks`` rank processes on a localhost rendezvous,
    every one a child on this host (so they share its cards whatever the
    grid); returns their records (a failed rank raises with its log
    tail)."""
    from dgen_tpu_torch.parallel.launch import spawn_local_ranks

    cmd = [sys.executable, "-m", "dgen_tpu_torch.tools.bench_scale", "--device", device,
           "--rank-point", str(n_agents), "--years", str(years)]
    with tempfile.TemporaryDirectory(prefix="dgen-scale-") as work:
        try:
            return spawn_local_ranks(cmd, n_ranks, work, cwd=_ROOT,
                                     env={"DGEN_TPU_MESH": f"{grid[0]}x{grid[1]}"},
                                     timeout_s=timeout_s)
        except RuntimeError as e:
            raise RuntimeError(f"the {n_ranks}-rank point: {e}") from None


def run_point(k: dict, n_agents: int, n_ranks: int, grid, years: int, device: str,
              timeout_s: float) -> tuple:
    """(point, national sums) of one measured point."""
    import torch

    if n_ranks == 1:
        recs = [measure(k, n_agents, years, torch.device(device))]
        if device == "cuda":
            # the rank processes of the next points need the card back
            torch.cuda.empty_cache()
    else:
        recs = _spawn_point(k, n_agents, n_ranks, grid, years, device, timeout_s)
    walls = [max(r["year_s"][i] for r in recs) for i in range(years)]
    steady = walls[1:]
    if steady:
        rate, proto = n_agents * len(steady) / max(sum(steady), 1e-9), "steady"
    else:
        rate, proto = n_agents / max(walls[0], 1e-9), "first_year"
    cards = _card_count(device)
    point = {
        "devices": n_ranks, "mesh": f"{grid[0]}x{grid[1]}", "agents": n_agents,
        "model_years": years, "generate_s": max(r["generate_s"] for r in recs),
        "build_s": max(r["build_s"] for r in recs), "year_s": walls,
        "first_year_s": walls[0],
        "steady_year_s": sum(steady) / len(steady) if steady else None,
        "agent_years_per_sec": rate, "rate_protocol": proto,
        "ranks_per_card": (-(-n_ranks // cards) if cards else None),
        "by_rank": [{key: r[key] for key in ("agents", "rows", "agent_chunk",
                                             "max_memory_allocated")} for r in recs],
    }
    return point, recs[0]["sums"]


def drill_at_size(k: dict, device: str) -> dict:
    """The gang drill on the drill's national world: ``drill_procs`` ranks,
    rank 1 killed at its second year's export; the gang must resume from
    the merged frontier, finish every year, and verify clean."""
    from dgen_tpu_torch.config import GangConfig
    from dgen_tpu_torch.resilience.gang import GangSupervisor
    from dgen_tpu_torch.resilience.manifest import verify_run_dir
    from dgen_tpu_torch.resilience.supervisor import RetryPolicy

    years = [START_YEAR, START_YEAR + 2]
    run_dir = tempfile.mkdtemp(prefix="dgen-scale-drill-")
    gcfg = GangConfig(n_processes=k["drill_procs"], platform=device,
                      boot_timeout_s=3600.0, stall_timeout_s=1800.0, poll_interval_s=0.2,
                      max_restarts=3, restart_window_s=86400.0)
    worker_env = {"DGEN_GANG_WORLD": "national", "DGEN_AGENTS": str(k["drill"]),
                  "DGEN_GANG_TARIFF_MIX": k["tariff_mix"],
                  "DGEN_GANG_SIZING_ITERS": str(k["sizing_iters"]),
                  "DGEN_GANG_ECON_YEARS": str(k["econ_years"]),
                  "DGEN_END_YEAR": str(years[-1])}
    if k["chunk"]:
        worker_env["DGEN_TPU_AGENT_CHUNK"] = str(k["chunk"])

    def kill_env(i, attempt):
        if i == 1 and attempt == 0:
            return {"DGEN_TPU_FAULTS": "gang_worker_kill@2:kill"}
        return None

    t0 = time.time()
    report = GangSupervisor(run_dir, years, config=gcfg,
                            policy=RetryPolicy(backoff_base_s=1.0), env_for=kill_env,
                            worker_env=worker_env).run()
    wall = time.time() - t0
    verify_ok = all(r.ok for r in verify_run_dir(run_dir))
    died = report.attempts[0]
    return {
        "agents": k["drill"], "processes": k["drill_procs"], "years": years,
        "wall_s": wall, "restarts": report.restarts,
        "detect_s": died.detect_s, "teardown_s": died.teardown_s,
        "relaunch_wall_s": report.relaunch_wall_s,
        "recovery_wall_s": report.recovery_wall_s,
        "card_free_before": report.card_free_before,
        "card_free_relaunch": report.card_free_relaunch,
        "by_rank": [{key: d.get(key) for key in ("agents", "agent_chunk",
                                                 "max_memory_allocated",
                                                 "memory_budget_bytes", "resumed_after")}
                    for d in report.done],
        "succeeded": report.succeeded, "completed_through": report.completed_through,
        "manifest_verify_ok": verify_ok, "run_dir": run_dir,
        "ok": bool(report.succeeded and report.restarts >= 1 and verify_ok
                   and report.completed_through == years[-1]),
    }


def _rank_point(args) -> int:
    """One rank of a multi-rank point: its record as the last line."""
    from dgen_tpu_torch.parallel.launch import initialize_multihost
    from dgen_tpu_torch.parallel.mesh import shutdown

    topo = initialize_multihost(device=args.device)
    try:
        rec = measure(knobs(), args.rank_point, args.years, topo.device, ranks=topo)
        print(json.dumps(rec), flush=True)
    finally:
        shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dgen_tpu_torch.tools.bench_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (ranks over gloo on the host)")
    ap.add_argument("--rank-point", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--years", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from dgen_tpu_torch.config import resolve_device
    from dgen_tpu_torch.utils.atomic import atomic_write_json

    device = resolve_device(args.device).type
    if args.rank_point:
        return _rank_point(args)
    k = knobs()
    cards = _card_count(device)
    most = max(k["devices"])
    shared = device == "cuda" and most > cards
    card = None
    if device == "cuda":
        from dgen_tpu_torch.presets import device_label

        card = device_label(torch.device("cuda", 0))
    payload = {
        "metric": "agent_years_per_sec",
        "protocol": {
            "generator": "models.synth national (state-stratified)",
            "tariff_mix": k["tariff_mix"], "cluster_tariffs": bool(k["cluster"]),
            "sizing_iters": k["sizing_iters"], "econ_years": k["econ_years"],
            "agent_chunk_per_rank": k["chunk"] or "automatic", "model_years": k["years"],
            "big_rows_one_year_protocol": k["big_rows"],
            "weak_rows_per_rank": k["weak_per_dev"], "strong_tables": k["strong"],
            "note": "steady = carry years (the first year apart); big points run one "
                    "year. A point of D ranks is D processes, its wall the slowest "
                    "rank's.",
        },
        "host": {"backend": device, "card_count": cards, "card": card,
                 "cpu_count": os.cpu_count(), "torch": torch.__version__},
        "scaling_claim": (
            "none: the ranks run on the CPU over gloo; the points measure the "
            "partition and the collectives, not a scaling curve" if device != "cuda"
            else f"none: the machine has {cards} card(s) and the points run up to "
            f"{most} ranks, so ranks share cards over gloo; the points measure the "
            "partition and the collectives, not a scaling curve" if shared
            else "the points of more than one rank run a card a rank"),
        "weak": [], "strong": [], "mesh2d_parity": None, "drill": None, "skipped": [],
    }
    out = k["out"]

    def flush():
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        atomic_write_json(out, payload, indent=1)

    def skip(stage, why):
        payload["skipped"].append({"stage": stage, "reason": why})
        print(f"[scale] SKIP {stage}: {why}", flush=True)
        flush()

    def remaining() -> float:
        return k["budget_s"] - (time.time() - _T0)

    timeout = max(60.0, remaining())
    for d in k["devices"]:
        if not k["weak_per_dev"]:
            break
        if remaining() < 60:
            skip(f"weak@{d}", "budget exhausted")
            continue
        pt, _ = run_point(k, k["weak_per_dev"] * d, d, (1, d), k["years"], device, timeout)
        pt["rows_per_rank"] = k["weak_per_dev"]
        payload["weak"].append(pt)
        print(f"[scale] weak D={d}: {pt['agent_years_per_sec']:.1f} ay/s", flush=True)
        flush()
    small = [n for n in k["strong"] if n < k["big_rows"]]
    for n in k["strong"]:
        big = n >= k["big_rows"]
        years = 1 if big else k["years"]
        for d in k["devices"]:
            if d < 2 and big:
                continue
            if remaining() < (600 if big else 120):
                skip(f"strong@{n}x{d}", "budget exhausted")
                continue
            pt, sums = run_point(k, n, d, (1, d), years, device, timeout)
            payload["strong"].append(pt)
            print(f"[scale] strong N={n} D={d}: {pt['agent_years_per_sec']:.1f} ay/s",
                  flush=True)
            flush()
            if (k["mesh2d"] and payload["mesh2d_parity"] is None and not big and small
                    and n == max(small) and d == most and d >= 4):
                pt2, sums2 = run_point(k, n, d, (2, d // 2), years, device, timeout)
                a, b = np.asarray(sums), np.asarray(sums2)
                rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-30)))
                payload["mesh2d_parity"] = {
                    "agents": n, "flat": pt["mesh"], "grid": pt2["mesh"], "point": pt2,
                    "max_rel_diff": rel, "tolerance": MESH2D_RTOL,
                    "ok": rel <= MESH2D_RTOL}
                print(f"[scale] 2-D parity {pt2['mesh']} vs {pt['mesh']}: rel {rel:.2e}",
                      flush=True)
                flush()
    if k["drill"]:
        if remaining() < 300:
            skip("drill", "budget exhausted")
        else:
            payload["drill"] = drill_at_size(k, device)
            flush()
    payload["wall_s"] = time.time() - _T0
    flush()
    print(f"[scale] done in {payload['wall_s']:.1f} s -> {out}", flush=True)
    # a gate that is on but never ran does not read as a pass; only an
    # explicit MESH2D=0 / DRILL=0 waives it
    missing = [g for g, on in (("mesh2d_parity", k["mesh2d"] and most >= 4),
                               ("drill", k["drill"])) if on and payload[g] is None]
    if missing:
        print(f"[scale] FAIL: enabled gate(s) never ran: {', '.join(missing)}", flush=True)
    ok = payload["mesh2d_parity"] is None or payload["mesh2d_parity"]["ok"]
    drill_ok = payload["drill"] is None or payload["drill"].get("ok")
    print(json.dumps({"ok": bool(ok and drill_ok and not missing),
                      "scaling_claim": payload["scaling_claim"], "out": out}))
    return 0 if (ok and drill_ok and not missing) else 1


if __name__ == "__main__":
    raise SystemExit(main())
