"""CLI: ``python -m dgen_tpu_torch.resilience {run,verify,drill}`` (port
of ``python -m dgen_tpu.resilience``; on the card unless ``--device
cpu``).

``run``
    A supervised synthetic-population run: bounded retry, checkpoint
    resume and the degradations, with crash-consistent exports and a
    content-hashed manifest. ``--faults`` (or ``DGEN_TPU_FAULTS``) injects
    deterministic failures::

        python -m dgen_tpu_torch.resilience run --agents 512 --end-year 2030 \\
            --run-dir runs/supervised --faults "ckpt_save@3;year_step@4:oom"

``verify``
    Audit a manifested run directory (content hashes, byte counts, stale
    temp files, checkpoint trees); exit 0 when every manifest verifies,
    1 when anything is missing or corrupt, 2 when there is no manifest::

        python -m dgen_tpu_torch.resilience verify runs/supervised

``drill``
    The fault matrix on a small population: every run-path fault site
    fired mid-run, recovered, and compared byte for byte against an
    uninterrupted run. ``--quarantine`` runs the quarantine drill instead
    (``--fast``: its load-time rounds only). ``--serve-fleet`` runs the
    serving-fleet drill (``--replicas``, ``--requests``; ``--layers`` arms
    the answer surface and the shared result cache), ``--serve-scale`` the
    autoscale drill (:mod:`.fleetdrill`)::

        python -m dgen_tpu_torch.resilience drill --serve-fleet --layers --agents 64
        python -m dgen_tpu_torch.resilience drill --serve-scale --agents 64

    ``--gang`` runs the rank gang's drill (:mod:`.gangdrill`): a clean
    gang of ``--gang-processes`` ranks, one rank killed mid-year, one
    stalled (``--no-gang-stall`` skips it; it needs ``--end-year`` 2018 or
    later, the default there), and a stop then a resume at
    ``--gang-shrink`` ranks (0 skips it), every round's parts equal to the
    clean gang's bit for bit and the merged manifest verifying::

        python -m dgen_tpu_torch.resilience drill --gang --device cpu --agents 96
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def _cmd_run(args) -> int:
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.resilience.drill import make_synth_runner
    from dgen_tpu_torch.resilience.supervisor import RetryPolicy, run_supervised

    if args.faults:
        faults.install(faults.FaultRegistry.parse(args.faults))
    else:
        faults.install_from_env()
    make_sim = make_synth_runner(
        n_agents=args.agents, states=tuple(args.states), end_year=args.end_year,
        sizing_iters=args.sizing_iters, device=args.device)
    policy = RetryPolicy(max_retries=args.max_retries, min_agent_chunk=args.min_chunk)
    try:
        res, report = run_supervised(
            make_sim, RunConfig(), run_dir=args.run_dir,
            checkpoint_dir=args.checkpoint_dir, collect=False, policy=policy,
            resume=args.resume)
    except BaseException as e:  # noqa: BLE001 — CLI boundary
        rep = getattr(e, "supervisor_report", None)
        print(json.dumps({"ok": False, "error": repr(e),
                          "report": rep.to_json() if rep is not None else None},
                         indent=1))
        return 1
    print(json.dumps({"ok": True, "run_dir": args.run_dir, "years": res.years,
                      "report": report.to_json()}, indent=1))
    return 0


def _cmd_verify(args) -> int:
    from dgen_tpu_torch.resilience.manifest import verify_run_dir

    try:
        reports = verify_run_dir(args.run_dir, deep=not args.shallow)
    except FileNotFoundError as e:
        print(f"verify: {e}", file=sys.stderr)
        return 2
    ok = all(r.ok for r in reports)
    print(json.dumps({"ok": ok, "reports": [r.to_json() for r in reports]}, indent=1))
    return 0 if ok else 1


def _print_record(rec: dict) -> int:
    rec.pop("supervisor_events", None)   # the event detail is for logs
    print(json.dumps(rec, indent=1))
    return 0 if rec["ok"] else 1


def _cmd_drill(args) -> int:
    from dgen_tpu_torch.resilience.drill import DRILL_SPECS, run_drill

    end_year = args.end_year or (2018 if args.gang else 2016)
    if args.gang:
        from dgen_tpu_torch.resilience.gangdrill import run_gang_drill

        root = args.root or tempfile.mkdtemp(prefix="dgen-gang-drill-")
        return _print_record(run_gang_drill(
            root, processes=args.gang_processes, shrink_to=args.gang_shrink,
            total_devices=args.gang_devices or None, agents=args.agents,
            end_year=end_year, stall=not args.no_gang_stall, device=args.device))
    if args.serve_scale:
        from dgen_tpu_torch.resilience.fleetdrill import run_scale_drill

        return _print_record(run_scale_drill(agents=args.agents, end_year=end_year,
                                             device=args.device))
    if args.serve_fleet:
        from dgen_tpu_torch.resilience.fleetdrill import run_fleet_drill

        return _print_record(run_fleet_drill(
            replicas=args.replicas, agents=args.agents, end_year=end_year,
            requests=args.requests, layers=args.layers, device=args.device))
    if args.quarantine:
        from dgen_tpu_torch.resilience.quarantinedrill import run_quarantine_drill

        root = args.root or tempfile.mkdtemp(prefix="dgen-qdrill-")
        rec = run_quarantine_drill(root, n_agents=args.agents, end_year=end_year,
                                   fast=args.fast, device=args.device)
        print(json.dumps(rec, indent=1))
        return 0 if rec["ok"] else 1
    root = args.root or tempfile.mkdtemp(prefix="dgen-fault-drill-")
    specs = DRILL_SPECS
    if args.sites:
        wanted = set(args.sites.split(","))
        unknown = wanted - {s[0] for s in DRILL_SPECS}
        if unknown:
            print(f"drill: unknown site(s) {sorted(unknown)}", file=sys.stderr)
            return 2
        specs = tuple(s for s in DRILL_SPECS if s[0] in wanted)
    rec = run_drill(root, n_agents=args.agents, end_year=end_year, specs=specs,
                    device=args.device)
    print(json.dumps(rec, indent=1))
    return 0 if rec["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.resilience",
        description="fault-injected, self-healing run supervision")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the plain versions)")

    run = sub.add_parser("run", help="supervised synthetic run")
    run.add_argument("--agents", type=int, default=512)
    run.add_argument("--states", nargs="*", default=["DE", "CA", "TX"])
    run.add_argument("--end-year", type=int, default=2030)
    run.add_argument("--sizing-iters", type=int, default=8)
    run.add_argument("--run-dir", required=True)
    run.add_argument("--checkpoint-dir", default=None,
                     help="default: <run-dir>/checkpoints")
    run.add_argument("--faults", default=None,
                     help="fault spec (resilience.faults grammar)")
    run.add_argument("--max-retries", type=int, default=4)
    run.add_argument("--min-chunk", type=int, default=128,
                     help="OOM chunk-halving floor")
    run.add_argument("--resume", action="store_true",
                     help="resume an existing run directory")
    device_arg(run)
    run.set_defaults(fn=_cmd_run)

    ver = sub.add_parser("verify", help="audit a run directory")
    ver.add_argument("run_dir")
    ver.add_argument("--shallow", action="store_true",
                     help="existence and byte counts only (no re-hash)")
    ver.set_defaults(fn=_cmd_verify)

    drl = sub.add_parser("drill", help="fault matrix drill")
    drl.add_argument("--agents", type=int, default=96)
    drl.add_argument("--end-year", type=int, default=None,
                     help="last model year (default 2016)")
    drl.add_argument("--root", default=None,
                     help="drill directory (default: a fresh temporary one)")
    drl.add_argument("--sites", default=None,
                     help="comma list of drill names to run (default: all)")
    drl.add_argument("--quarantine", action="store_true",
                     help="the quarantine drill instead: corrupt rows at ingest, "
                          "at bank load and mid-run, each contained")
    drl.add_argument("--fast", action="store_true",
                     help="quarantine drill: the load-time rounds only")
    drl.add_argument("--serve-fleet", action="store_true",
                     help="the serving-fleet drill instead: a replica fleet, one "
                          "replica killed and one hung under closed-loop load; every "
                          "answer bit for bit equal to an in-process engine's")
    drl.add_argument("--serve-scale", action="store_true",
                     help="the autoscale drill instead: a one-replica fleet scaled "
                          "1 -> 2 -> 1 on a synthetic signal, with a result-cache hit "
                          "byte-identical to the engine's answer")
    drl.add_argument("--layers", action="store_true",
                     help="fleet drill: arm the answer surface and the shared result "
                          "cache on every replica; all three paths must answer")
    drl.add_argument("--replicas", type=int, default=2, help="fleet drill: replicas")
    drl.add_argument("--requests", type=int, default=80,
                     help="fleet drill: client requests")
    drl.add_argument("--gang", action="store_true",
                     help="the rank gang's drill instead: a gang of rank processes "
                          "with a rank killed mid-year, a rank stalled, and a P -> P' "
                          "resharded resume; every rank's parts equal to an "
                          "uninterrupted gang's bit for bit, the merged manifest "
                          "verifying (--end-year 2018 or later for the stall round)")
    drl.add_argument("--gang-processes", type=int, default=4,
                     help="gang drill: ranks P")
    drl.add_argument("--gang-shrink", type=int, default=2,
                     help="gang drill: ranks P' of the resumed round (0 skips it)")
    drl.add_argument("--gang-devices", type=int, default=0,
                     help="gang drill: ranks over all hosts kept through the "
                          "shrink (0: one a process); sets the ranks a host")
    drl.add_argument("--no-gang-stall", action="store_true",
                     help="gang drill: skip the heartbeat-stall round")
    device_arg(drl)
    drl.set_defaults(fn=_cmd_drill)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
