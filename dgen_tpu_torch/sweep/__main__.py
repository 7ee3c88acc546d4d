"""CLI: ``python -m dgen_tpu_torch.sweep`` runs a policy sweep (ITC
schedule x retail-price escalator x storage-cost scale) over one
synthetic population, or a named preset's (``--preset``), on the card by
default (``--device cpu`` runs the plain versions).

Each axis takes a comma list; the sweep is their cartesian product::

    python -m dgen_tpu_torch.sweep --agents 512 --states DE CA \\
        --end-year 2030 --itc 0.30,0.10,0.0 --esc 0.0,0.01 \\
        --run-dir runs/itc-sweep

It prints each scenario's final adoption and the deltas against the
baseline (the first combination unless ``--baseline`` picks another),
with ``--run-dir`` exports every scenario's surfaces and ``sweep.json``,
and ends with a one-line JSON record. Real populations go through the
programmatic API (:class:`dgen_tpu_torch.sweep.SweepSimulation`).

Started as the ranks of a multi-rank run (``DGEN_COORDINATOR``,
``DGEN_NUM_PROCESSES``, ``DGEN_PROCESS_ID``, as ``parallel.launch``
reads them) every rank runs the sweep on its shard
(``SweepSimulation(ranks=)``); the results are gathered over the ranks,
and rank 0 prints the report, exports, and writes ``--collect`` (every
scenario's per-agent fields with the agent ids, an ``.npz``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np


def _floats(s: str) -> list:
    return [float(tok) for tok in s.split(",") if tok.strip()]


def build_sweep(args, device):
    """(population, ScenarioConfig, members, labels, with_hourly) of the
    CLI's sweep: the cartesian product of its axes over the synthetic
    population of ``--states``, or a preset's world (``--preset``)."""
    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario as scen

    if args.preset:
        from dgen_tpu_torch import presets

        pop, cfg, _, with_hourly, _ = presets.world(args.preset, args.agents,
                                                    end_year=args.end_year, device=device)
        with_hourly = with_hourly or args.with_hourly
    else:
        cfg = ScenarioConfig(name="sweep", start_year=args.start_year,
                             end_year=args.end_year, anchor_years=())
        pop = synth.generate_population(args.agents, states=list(args.states), seed=7,
                                        device=device)
        with_hourly = args.with_hourly
    years = list(cfg.model_years)
    Y, S = len(years), len(cfg.sectors)
    R = pop.n_regions
    members, labels = [], []
    for itc, esc, bscale in itertools.product(args.itc, args.esc, args.batt_scale):
        mult = (((1.0 + esc) ** np.arange(Y, dtype=np.float32))[:, None, None]
                * np.ones((1, R, S), np.float32))
        overrides = {
            "itc_fraction": np.full((Y, S), itc, np.float32),
            "elec_price_multiplier": mult.astype(np.float32),
            "elec_price_escalator": np.full(
                (Y, R, S), min(max(esc, -0.01), 0.01), np.float32),
        }
        if args.attachment_rate is not None:
            overrides["attachment_rate"] = np.full(pop.table.n_groups, args.attachment_rate,
                                                   np.float32)
        base = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups, n_regions=R,
                                   device=device, overrides=overrides)
        members.append(dataclasses.replace(
            base, batt_capex_per_kwh=base.batt_capex_per_kwh * bscale,
            batt_capex_per_kwh_combined=base.batt_capex_per_kwh_combined * bscale))
        labels.append(f"itc{itc:g}-esc{esc:g}-batt{bscale:g}")
    return pop, cfg, members, labels, with_hourly


def parser() -> argparse.ArgumentParser:
    """The CLI's arguments (:func:`build_sweep` reads its namespace)."""
    ap = argparse.ArgumentParser(prog="python -m dgen_tpu_torch.sweep",
                                 description="batched multi-scenario sweep on one population")
    ap.add_argument("--preset", default="",
                    help="a named preset's world (presets.PRESETS) in place of the "
                         "synthetic population of --states")
    ap.add_argument("--attachment-rate", type=float, default=None,
                    help="every group's battery attachment rate")
    ap.add_argument("--collect", default="",
                    help="write every scenario's per-agent fields and the agent ids "
                         "to this .npz (rank 0 of a multi-rank run)")
    ap.add_argument("--agents", type=int, default=512)
    ap.add_argument("--states", nargs="*", default=["DE", "CA", "TX"])
    ap.add_argument("--start-year", type=int, default=2014)
    ap.add_argument("--end-year", type=int, default=2030)
    ap.add_argument("--itc", type=_floats, default=[0.30, 0.0],
                    help="comma list of flat ITC fractions")
    ap.add_argument("--esc", type=_floats, default=[0.0],
                    help="comma list of retail-price escalators (/yr)")
    ap.add_argument("--batt-scale", type=_floats, default=[1.0],
                    help="comma list of storage capex multipliers")
    ap.add_argument("--baseline", type=int, default=0)
    ap.add_argument("--sizing-iters", type=int, default=8)
    ap.add_argument("--with-hourly", action="store_true")
    ap.add_argument("--run-dir", default=None,
                    help="export the surfaces and sweep.json here")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu (the plain versions)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from dgen_tpu_torch.config import resolve_device
    from dgen_tpu_torch.parallel.launch import initialize_multihost
    from dgen_tpu_torch.parallel.mesh import RankTopology, shutdown

    topo = initialize_multihost(device=args.device) or RankTopology.single(
        resolve_device(args.device))
    try:
        return _run(args, topo)
    finally:
        shutdown()


def _run(args, topo) -> int:
    """The sweep on ``topo``'s rank (one process: the whole table)."""
    import sys

    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.ops import billkernels, dispatch
    from dgen_tpu_torch.sweep import SweepSimulation

    device = topo.device
    pop, cfg, members, labels, with_hourly = build_sweep(args, device)
    Y = len(cfg.model_years)
    lead = topo.rank == 0
    if lead:
        print(f"sweep: {len(members)} scenario(s) x {args.agents} agents, {Y} model "
              f"years on {device}" + (f", {topo.world_size} ranks" if topo.distributed
                                      else ""))
    billkernels.reset_launches()
    dispatch.reset_launches()
    t0 = time.time()
    sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, cfg,
                            RunConfig(sizing_iters=args.sizing_iters),
                            with_hourly=with_hourly, labels=labels,
                            baseline=args.baseline, device=device, ranks=topo)
    del pop
    results = sweep.run(checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    wall = time.time() - t0
    launches = {**billkernels.LAUNCHES, **dispatch.LAUNCHES}
    if args.collect and lead:
        out = {"agent_id": results.host_agent_id, "mask": results.host_mask}
        for s, run in enumerate(results.runs):
            for k, v in run.agent.items():
                out[f"{s}/{k}"] = v
        np.savez(args.collect, **out)
    if not lead:
        print(json.dumps({"rank": topo.rank, "world": topo.world_size,
                          "launches": launches, "wall_s": round(wall, 3),
                          "imports_jax": sys.modules.get("jax") is not None,
                          "imports_dgen_tpu": sys.modules.get("dgen_tpu") is not None}))
        return 0
    try:
        report = results.delta_report()
    except ValueError as e:
        # a fully resumed sweep collected no new years
        report = {"scenarios": [], "baseline": labels[args.baseline]}
        print(f"delta report unavailable: {e}")
    for s in report["scenarios"]:
        tag = " (baseline)" if s["is_baseline"] else ""
        if s.get("no_new_years"):
            print(f"  {s['scenario']}{tag}: no new years (resumed)")
            continue
        f = s["final"]
        print(f"  {s['scenario']}{tag}: adopters {f['adopters']:.1f} "
              f"(delta {f['adopters_delta']:+.1f}), kW delta "
              f"{f['system_kw_cum_delta']:+.1f}, fleet NPV delta "
              f"{f['npv_total_delta']:+.0f}")
    if args.run_dir:
        try:
            results.export(args.run_dir, state_names=list(synth.STATES),
                           meta={"cli": True})
            print(f"exported to {args.run_dir}")
        except ValueError as e:
            print(f"export skipped: {e}")
    print(json.dumps({
        "scenarios": len(members),
        "agents": args.agents,
        "years": Y,
        "device": device.type,
        "rank": topo.rank,
        "world": topo.world_size,
        "wall_s": round(wall, 2),
        "per_scenario_wall_s": round(wall / len(members), 2),
        "bank_bytes_shared": results.bank_bytes_shared,
        "groups": [{"mode": g.mode, "n": g.n_scenarios} for g in results.plan.groups],
        "agent_chunk": results.plan.agent_chunk,
        "baseline": report["baseline"],
        "launches": launches,
        "imports_jax": sys.modules.get("jax") is not None,
        "imports_dgen_tpu": sys.modules.get("dgen_tpu") is not None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
