"""CLI: ``python -m dgen_tpu_torch.ensemble`` runs a Monte-Carlo ensemble
over one synthetic population in one process, on the card by default
(``--device cpu`` runs the plain versions)::

    python -m dgen_tpu_torch.ensemble --agents 512 --members 8 \\
        --end-year 2025 --cohort-rows 32 --cohort-year 2018

It prints the per-year p10/p50/p90 national adoption band as a one-line
JSON record. ``--check-parity`` also runs the E = 1 zero-draw ensemble
beside a plain ``Simulation.run`` and requires them equal bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dgen_tpu_torch.ensemble",
                                 description="Monte-Carlo ensemble on one population")
    ap.add_argument("--agents", type=int, default=512)
    ap.add_argument("--states", nargs="*", default=["DE", "CA", "TX"])
    ap.add_argument("--start-year", type=int, default=2014)
    ap.add_argument("--end-year", type=int, default=2020)
    ap.add_argument("--members", type=int, default=None,
                    help="ensemble width E (default: env DGEN_TPU_ENSEMBLE, else 4)")
    ap.add_argument("--seed", type=int, default=None,
                    help="draw seed (default: env DGEN_TPU_ENSEMBLE_SEED, else 0)")
    ap.add_argument("--zero-draws", action="store_true",
                    help="zero-width DrawSpec: every member is the base scenario")
    ap.add_argument("--cohort-rows", type=int, default=0,
                    help="reschedule this many (tail) rows as a future cohort")
    ap.add_argument("--cohort-year", type=int, default=2017,
                    help="calendar entry year of the cohort rows")
    ap.add_argument("--sizing-iters", type=int, default=8)
    ap.add_argument("--check-parity", action="store_true",
                    help="require the E=1 zero-draw ensemble to equal Simulation.run")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--run-dir", default=None,
                    help="write the quantile block (ensemble.json) here")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.ensemble import DEFAULT_DRAWS, DrawSpec, EnsembleSimulation
    from dgen_tpu_torch.ensemble.driver import ENV_MEMBERS
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.utils.atomic import atomic_write_json

    cfg = ScenarioConfig(name="ensemble", start_year=args.start_year,
                         end_year=args.end_year, anchor_years=())
    pop = synth.generate_population(args.agents, states=list(args.states), seed=7,
                                    device=args.device)
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, device=args.device)
    rc = RunConfig(sizing_iters=args.sizing_iters)

    parity = None
    if args.check_parity:
        ref = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                         device=args.device).run(collect=True)
        r1 = EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                                n_members=1, draws=DrawSpec(),
                                device=args.device).run(collect=True)[0]
        parity = list(ref.years) == list(r1.years) and all(
            np.array_equal(ref.agent[k], r1.agent[k]) for k in ref.agent)
        if not parity:
            print("PARITY FAILED: the E=1 zero-draw ensemble differs from Simulation.run")
            return 1

    entry = None
    if args.cohort_rows > 0:
        # the tail of the alive rows enters at --cohort-year instead of
        # being alive from the start
        entry = np.zeros(pop.table.n_agents, np.float32)
        alive = np.flatnonzero(pop.table.mask.cpu().numpy() > 0)
        entry[alive[-min(args.cohort_rows, len(alive)):]] = float(args.cohort_year)

    n_members = (args.members if args.members is not None
                 else int(os.environ.get(ENV_MEMBERS, "").strip() or 4))
    draws = DrawSpec() if args.zero_draws else DEFAULT_DRAWS
    t0 = time.time()
    ens = EnsembleSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                             n_members=n_members, seed=args.seed, draws=draws,
                             entry_year=entry, device=args.device)
    results = ens.run(checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    wall = time.time() - t0
    stats = results.quantiles
    if args.run_dir:
        os.makedirs(args.run_dir, exist_ok=True)
        atomic_write_json(os.path.join(args.run_dir, "ensemble.json"), stats.to_json())
    print(json.dumps({
        "members": ens.n_members,
        "agents": args.agents,
        "years": [int(y) for y in np.asarray(stats.years)],
        "mode": ens.mode,
        "seed": ens.seed,
        "draws": "zero" if draws.is_zero else "default",
        "cohort_rows": int(args.cohort_rows),
        "quantiles": [float(q) for q in stats.quantiles],
        "adopters_band": {k: [round(float(x), 3) for x in v]
                          for k, v in stats.band("adopters").items()},
        "parity": parity,
        "device": args.device,
        "wall_s": round(wall, 2),
        "per_member_wall_s": round(wall / ens.n_members, 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
