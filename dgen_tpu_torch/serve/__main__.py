"""CLI: ``python -m dgen_tpu_torch.serve`` — stand up the what-if query
endpoint over a synthetic population on the card (port of the single
process modes of ``python -m dgen_tpu.serve``).

    python -m dgen_tpu_torch.serve --agents 8192 --port 8178
    curl -s localhost:8178/readyz

``--build-surface DIR`` precomputes the zero-override answer surface
(batch mode: build, print the header, exit); ``--surface DIR`` serves
from one (provenance-gated); ``--cache-dir DIR`` keeps an exact result
cache there. ``--device cpu`` runs the plain versions of the kernels;
the default is the card, and with none the CLI raises. The fleet modes
(``--fleet``, ``--autoscale``, ``--replica-index``) are not ported: they
raise ``NotImplementedError`` naming ``ROADMAP.md`` item 11's fleet part.

Serve knobs come from :class:`dgen_tpu_torch.config.ServeConfig` (env:
``DGEN_TPU_SERVE_*``), run knobs from ``RunConfig.from_env``. SIGTERM
drains gracefully (finish in-flight requests, then exit).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from typing import Optional

#: the fleet part of serving, which the port does not have yet
FLEET_ITEM = "ROADMAP.md item 11 (serving: the fleet part)"


def build_sim(n_agents: int, *, seed: int = 7, start_year: int = 2014,
              end_year: int = 2050, econ_years: Optional[int] = None,
              sizing_iters: Optional[int] = None, device="cuda"):
    """The CLI's Simulation: a synthetic population of ``n_agents`` from
    ``seed`` under uniform scenario inputs (the JAX package's serve CLI
    builds the same world), on ``device``."""
    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.models.simulation import Simulation

    cfg = ScenarioConfig(name="serve", start_year=start_year, end_year=end_year,
                         anchor_years=())
    pop = synth.generate_population(n_agents, seed=seed, device=device)
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, device=device)
    rc = RunConfig.from_env()
    if sizing_iters is not None:
        rc = dataclasses.replace(rc, sizing_iters=sizing_iters)
    kw = {} if econ_years is None else dict(econ_years=econ_years)
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                      device=device, **kw)


def _sim_from_args(args):
    return build_sim(args.agents, seed=args.seed, start_year=args.start_year,
                     end_year=args.end_year, econ_years=args.econ_years,
                     sizing_iters=args.sizing_iters, device=args.device)


def _serve_config(args):
    from dgen_tpu_torch.config import ServeConfig

    overrides = {}
    for k, v in (("host", args.host), ("port", args.port),
                 ("max_batch", args.max_batch), ("max_wait_ms", args.max_wait_ms),
                 ("min_bucket", args.min_bucket), ("surface_dir", args.surface),
                 ("result_cache_dir", args.cache_dir),
                 ("result_cache_entries", args.cache_entries)):
        if v is not None:
            overrides[k] = v
    if args.no_warmup:
        overrides["warmup"] = False
    return ServeConfig.from_env(**overrides)


def attach_layers(engine, serve_cfg):
    """Attach the engine-free layers a config names: the provenance-gated
    answer surface and the result cache. A refused surface is logged and
    recorded, and the engine answers in its place."""
    from dgen_tpu_torch.serve import surface as surface_mod
    from dgen_tpu_torch.serve.resultcache import ResultCache

    if serve_cfg.surface_dir:
        surface_mod.load_and_attach(engine, serve_cfg.surface_dir)
    if serve_cfg.result_cache_dir:
        engine.attach_result_cache(ResultCache(
            serve_cfg.result_cache_dir,
            provenance_key=surface_mod.provenance_key(engine),
            max_entries=serve_cfg.result_cache_entries))
    return engine


def _build_surface_cmd(args) -> None:
    from dgen_tpu_torch.serve.engine import ServeEngine
    from dgen_tpu_torch.serve.surface import build_surface

    serve_cfg = _serve_config(args)
    engine = ServeEngine(_sim_from_args(args))
    bucket = serve_cfg.max_batch
    engine.warmup([bucket])
    header = build_surface(engine, args.build_surface, bucket)
    print(json.dumps({
        "surface_dir": args.build_surface,
        "bucket": bucket,
        "years": header["meta"]["year_indices"],
        "rows": header["columns"]["agent_id"]["shape"][1],
        "content_hash": header["content_hash"],
        "build_wall_s": header["meta"]["build_wall_s"],
        "provenance": header["meta"]["provenance"],
    }, indent=1))


def _run_single(args) -> None:
    from dgen_tpu_torch.serve.engine import ServeEngine
    from dgen_tpu_torch.serve.server import ServeApp, serve_forever

    serve_cfg = _serve_config(args)
    engine = attach_layers(ServeEngine(_sim_from_args(args)), serve_cfg)
    serve_forever(ServeApp(engine, serve_cfg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dgen_tpu_torch.serve",
                                 description="online what-if query engine")
    ap.add_argument("--agents", type=int, default=8192)
    ap.add_argument("--start-year", type=int, default=2014)
    ap.add_argument("--end-year", type=int, default=2050)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--econ-years", type=int, default=None)
    ap.add_argument("--sizing-iters", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain "
                         "versions of the kernels)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--min-bucket", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--surface", default=None, metavar="DIR",
                    help="serve zero-override queries from this precomputed answer "
                         "surface (provenance-gated)")
    ap.add_argument("--build-surface", default=None, metavar="DIR",
                    help="build the answer surface for this population and config "
                         "into DIR and exit")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="exact result cache directory")
    ap.add_argument("--cache-entries", type=int, default=None,
                    help="result cache entry bound (LRU eviction)")
    # the JAX package's fleet modes: refused until the fleet is ported
    ap.add_argument("--fleet", type=int, default=None, metavar="N")
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--min-replicas", type=int, default=None)
    ap.add_argument("--max-replicas", type=int, default=None)
    ap.add_argument("--replica-index", type=int, default=None)
    ap.add_argument("--portfile", default=None)
    args = ap.parse_args(argv)

    for flag, given in (("--fleet", args.fleet is not None),
                        ("--autoscale", args.autoscale),
                        ("--min-replicas", args.min_replicas is not None),
                        ("--max-replicas", args.max_replicas is not None),
                        ("--replica-index", args.replica_index is not None),
                        ("--portfile", args.portfile is not None)):
        if given:
            raise NotImplementedError(
                f"{flag}: the serving fleet (replica supervisor, routing front, "
                f"autoscaler) is not ported; it comes with {FLEET_ITEM}")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.build_surface is not None:
        _build_surface_cmd(args)
    else:
        _run_single(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
