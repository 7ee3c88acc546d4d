"""CLI: ``python -m dgen_tpu_torch.sweep`` runs a policy sweep (ITC
schedule x retail-price escalator x storage-cost scale) over one
synthetic population in one process, on the card by default
(``--device cpu`` runs the plain versions).

Each axis takes a comma list; the sweep is their cartesian product::

    python -m dgen_tpu_torch.sweep --agents 512 --states DE CA \\
        --end-year 2030 --itc 0.30,0.10,0.0 --esc 0.0,0.01 \\
        --run-dir runs/itc-sweep

It prints each scenario's final adoption and the deltas against the
baseline (the first combination unless ``--baseline`` picks another),
with ``--run-dir`` exports every scenario's surfaces and ``sweep.json``,
and ends with a one-line JSON record. Real populations go through the
programmatic API (:class:`dgen_tpu_torch.sweep.SweepSimulation`).
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dgen_tpu_torch.sweep",
                                 description="batched multi-scenario sweep on one population")
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
    args = ap.parse_args(argv)

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.sweep import SweepSimulation

    cfg = ScenarioConfig(name="sweep", start_year=args.start_year,
                         end_year=args.end_year, anchor_years=())
    pop = synth.generate_population(args.agents, states=list(args.states), seed=7,
                                    device=args.device)
    years = list(cfg.model_years)
    Y, S = len(years), len(cfg.sectors)
    R = pop.n_regions

    members, labels = [], []
    for itc, esc, bscale in itertools.product(args.itc, args.esc, args.batt_scale):
        mult = (((1.0 + esc) ** np.arange(Y, dtype=np.float32))[:, None, None]
                * np.ones((1, R, S), np.float32))
        base = scen.uniform_inputs(
            cfg, n_groups=pop.table.n_groups, n_regions=R, device=args.device,
            overrides={
                "itc_fraction": np.full((Y, S), itc, np.float32),
                "elec_price_multiplier": mult.astype(np.float32),
                "elec_price_escalator": np.full(
                    (Y, R, S), min(max(esc, -0.01), 0.01), np.float32),
            })
        members.append(dataclasses.replace(
            base, batt_capex_per_kwh=base.batt_capex_per_kwh * bscale,
            batt_capex_per_kwh_combined=base.batt_capex_per_kwh_combined * bscale))
        labels.append(f"itc{itc:g}-esc{esc:g}-batt{bscale:g}")

    print(f"sweep: {len(members)} scenario(s) x {args.agents} agents, {Y} model years "
          f"on {args.device}")
    t0 = time.time()
    sweep = SweepSimulation(pop.table, pop.profiles, pop.tariffs, members, cfg,
                            RunConfig(sizing_iters=args.sizing_iters),
                            with_hourly=args.with_hourly, labels=labels,
                            baseline=args.baseline, device=args.device)
    results = sweep.run(checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    wall = time.time() - t0

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
        "device": args.device,
        "wall_s": round(wall, 2),
        "per_scenario_wall_s": round(wall / len(members), 2),
        "bank_bytes_shared": results.bank_bytes_shared,
        "groups": [{"mode": g.mode, "n": g.n_scenarios} for g in results.plan.groups],
        "baseline": report["baseline"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
