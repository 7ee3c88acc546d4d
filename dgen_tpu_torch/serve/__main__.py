"""CLI: ``python -m dgen_tpu_torch.serve`` — stand up the what-if query
endpoint over a synthetic population on the card (port of ``python -m
dgen_tpu.serve``).

Three serving modes:

* **single process** (default)::

      python -m dgen_tpu_torch.serve --agents 8192 --port 8178
      curl -s localhost:8178/readyz

* **fleet**: supervise N replicas behind the routing front
  (:mod:`.fleet`, :mod:`.front`; ``--autoscale`` sizes the fleet between
  ``--min-replicas`` and ``--max-replicas``, :mod:`.autoscale`)::

      python -m dgen_tpu_torch.serve --fleet 2 --agents 8192 --port 8177
      curl -s localhost:8177/metricz      # the fleet's aggregate

* **replica**: one fleet member, spawned by the supervisor: it binds
  ``--port 0``, writes ``--portfile`` once the socket is bound, then warms
  up on a thread, so ``/healthz`` answers while ``/readyz`` stays 503 until
  warmup completes (a failed warmup stays unready); it arms any
  ``DGEN_TPU_FAULTS`` spec of its environment (the fleet drill's)::

      python -m dgen_tpu_torch.serve --replica-index 0 --port 0 \\
          --portfile /tmp/replica-0.json --agents 8192

``--build-surface DIR`` precomputes the zero-override answer surface
(batch mode: build, print the header, exit); ``--surface DIR`` serves
from one (provenance-gated); ``--cache-dir DIR`` keeps an exact result
cache there, shared by every replica of a fleet. ``--device cpu`` runs
the plain versions of the kernels; the default is the card, and with
none the CLI raises (a fleet's replicas run on its ``--device``).

Serve knobs come from :class:`dgen_tpu_torch.config.ServeConfig` (env:
``DGEN_TPU_SERVE_*``), fleet knobs from ``FleetConfig`` (env:
``DGEN_TPU_FLEET_*``), run knobs from ``RunConfig.from_env``. SIGTERM
drains gracefully (finish in-flight requests, then exit).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import threading
from typing import Optional

logger = logging.getLogger(__name__)


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


def _run_replica(args) -> None:
    """One fleet member: bind first (liveness), the portfile second
    (discovery), warm up third (readiness)."""
    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.serve.engine import ServeEngine
    from dgen_tpu_torch.serve.server import ServeApp, make_server, serve_forever

    faults.install_from_env()   # the drill's per-replica fault specs
    serve_cfg = _serve_config(args)
    engine = attach_layers(ServeEngine(_sim_from_args(args)), serve_cfg)
    app = ServeApp(engine, serve_cfg, replica_index=args.replica_index,
                   defer_warmup=True)
    srv = make_server(app)
    if args.portfile:
        tmp = args.portfile + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"pid": os.getpid(), "port": srv.server_address[1],
                       "replica_index": args.replica_index}, f)
        os.replace(tmp, args.portfile)

    def _warm() -> None:
        try:
            app.warmup_now()
        except Exception:  # noqa: BLE001 - never ready is the signal
            logger.exception("replica %s warmup failed; staying unready",
                             args.replica_index)

    threading.Thread(target=_warm, name="dgen-serve-warmup", daemon=True).start()
    serve_forever(app, srv)


def _fleet_serve_args(args) -> list:
    """The replicas' command-line settings: the world, the device and the
    serve knobs of this command."""
    out = ["--agents", str(args.agents), "--start-year", str(args.start_year),
           "--end-year", str(args.end_year), "--seed", str(args.seed),
           "--device", args.device]
    for flag, v in (("--econ-years", args.econ_years),
                    ("--sizing-iters", args.sizing_iters),
                    ("--max-batch", args.max_batch), ("--min-bucket", args.min_bucket),
                    ("--max-wait-ms", args.max_wait_ms), ("--surface", args.surface),
                    ("--cache-dir", args.cache_dir),
                    ("--cache-entries", args.cache_entries)):
        if v is not None:
            out += [flag, str(v)]
    if args.no_warmup:
        out.append("--no-warmup")
    return out


def _run_fleet(args) -> None:
    """The supervisor, the routing front and (with ``--autoscale``) the
    autoscaler, until SIGTERM (drains the fleet) or SIGINT."""
    from dgen_tpu_torch.config import FleetConfig
    from dgen_tpu_torch.serve.fleet import ReplicaSupervisor, default_replica_cmd
    from dgen_tpu_torch.serve.front import (
        FleetFront,
        install_sigterm_drain_front,
        make_front_server,
    )

    overrides = {"n_replicas": args.fleet}
    for k, v in (("host", args.host), ("port", args.port),
                 ("min_replicas", args.min_replicas),
                 ("max_replicas", args.max_replicas)):
        if v is not None:
            overrides[k] = v
    if args.autoscale:
        overrides["autoscale"] = True
    fleet_cfg = FleetConfig.from_env(**overrides)
    sup = ReplicaSupervisor(default_replica_cmd(_fleet_serve_args(args)),
                            fleet_cfg).start()
    front = FleetFront(sup, fleet_cfg).start()
    scaler = None
    if fleet_cfg.autoscale:
        from dgen_tpu_torch.serve.autoscale import Autoscaler

        scaler = Autoscaler(sup, front.pressure, fleet_cfg).start()
    srv = make_front_server(front)
    install_sigterm_drain_front(front, srv)
    host, port = srv.server_address[:2]
    logger.info("dgen-tpu serve fleet: %d replicas (%d agents each, on %s), front on "
                "http://%s:%d (/query /healthz /readyz /metricz); fleet dir %s",
                fleet_cfg.n_replicas, args.agents, args.device, host, port,
                sup.fleet_dir)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("fleet front: shutting down")
    finally:
        if scaler is not None:
            scaler.stop()
        srv.server_close()
        front.close()
        sup.stop(drain=True)


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
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet mode: scale replicas between --min-replicas and "
                         "--max-replicas from the aggregated occupancy signal")
    ap.add_argument("--min-replicas", type=int, default=None)
    ap.add_argument("--max-replicas", type=int, default=None)
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="supervise N replicas behind the routing front")
    ap.add_argument("--replica-index", type=int, default=None,
                    help="run as fleet replica I (spawned by the supervisor)")
    ap.add_argument("--portfile", default=None,
                    help="replica mode: write {pid, port} here once the socket "
                         "is bound")
    args = ap.parse_args(argv)

    if args.fleet is not None and args.replica_index is not None:
        ap.error("--fleet and --replica-index are mutually exclusive")
    if args.build_surface is not None and (args.fleet is not None
                                           or args.replica_index is not None):
        ap.error("--build-surface is a batch command (no fleet or replica flags)")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.build_surface is not None:
        _build_surface_cmd(args)
    elif args.fleet is not None:
        _run_fleet(args)
    elif args.replica_index is not None or args.portfile:
        _run_replica(args)
    else:
        _run_single(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
