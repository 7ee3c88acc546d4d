"""Scale-out launch harness and the rank entry point (port of
``dgen_tpu/parallel/launch.py``).

The reference shards national runs by state across batch tasks that
never talk to each other. The port's equivalents:

* :func:`bin_states` and :func:`shard_commands`: the reference's
  size-binned state groups, and one launch line per bin for operators
  who run the reference's share-nothing process-per-bin model;
* :func:`initialize_multihost`: ``torch.distributed`` bring-up from the
  JAX package's ``DGEN_COORDINATOR`` (host:port), ``DGEN_NUM_PROCESSES``
  and ``DGEN_PROCESS_ID``, one process per rank, each rank then holding
  one state-partitioned shard of the agent table on its own device
  (``models.simulation.Simulation(ranks=)``);
* :func:`main` (``python -m dgen_tpu_torch.parallel.launch``): one rank's
  run, with the exporter's per-rank parts and per-rank checkpoints;
* :func:`run_with_recovery`: checkpoint-granular retries of one process,
  none on a multi-rank run (the ranks are restarted together);
* :func:`spawn_local_ranks`: a world of rank processes on this host on a
  fresh localhost rendezvous, for harnesses that drive one.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class StateBins:
    """Size-binned state groups (largest states in the last bin)."""

    bins: List[List[str]]

    def flat(self) -> List[str]:
        return [s for b in self.bins for s in b]


def bin_states(
    state_sizes: Dict[str, float],
    n_bins: int = 4,
) -> StateBins:
    """Greedy size-binning of states, the reference's small / mid /
    mid_large / large split generalized: states sorted by size are dealt
    into ``n_bins`` quantile groups, so each bin's tasks have comparable
    runtimes on one machine shape."""
    if not state_sizes:
        return StateBins(bins=[[] for _ in range(n_bins)])
    names = sorted(state_sizes, key=lambda s: state_sizes[s])
    splits = np.array_split(np.asarray(names, dtype=object), n_bins)
    return StateBins(bins=[list(map(str, s)) for s in splits])


def shard_commands(
    bins: StateBins,
    entry: str = "python -m dgen_tpu_torch.parallel.launch",
) -> List[str]:
    """Per-bin launch lines: each carries its shard index and
    comma-joined state list in its environment."""
    out = []
    for i, states in enumerate(bins.bins):
        if not states:
            continue
        out.append(
            f"DGEN_SHARD_INDEX={i} DGEN_SHARD_STATES={','.join(states)} "
            f"{entry}"
        )
    return out


def _env_int(value: Optional[int], var: str, coordinator: str) -> int:
    if value is not None:
        return int(value)
    raw = os.environ.get(var)
    if raw is None or not raw.strip():
        # an operator error in the launch environment, not a bug here:
        # name the variable and the contract
        raise ValueError(
            f"DGEN_COORDINATOR is set ({coordinator!r}) but {var} "
            "is missing: a multi-host launch needs DGEN_COORDINATOR, "
            "DGEN_NUM_PROCESSES and DGEN_PROCESS_ID set on every "
            "process (README.md 'Multi-rank runs')"
        )
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{var}={raw!r} is not an integer (multi-host launch "
            "env, README.md 'Multi-rank runs')"
        ) from None


def initialize_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    local_size: Optional[int] = None,
):
    """Start this process's rank of a multi-rank run.

    Reads ``DGEN_COORDINATOR`` (host:port of rank 0's rendezvous),
    ``DGEN_NUM_PROCESSES`` and ``DGEN_PROCESS_ID`` where the arguments are
    omitted, and ``DGEN_TPU_MESH`` for the (hosts, devices) grid. Returns
    False when no coordinator is configured (one process), else the
    rank's ``parallel.mesh.RankTopology`` (its device on ``device``'s
    type; NCCL when every local rank has a card, gloo otherwise).
    ``local_size``: ranks per host, the grid's second axis (default:
    ``parallel.mesh.default_mesh_shape``'s). A missing or non-integer
    variable raises ``ValueError`` naming it."""
    coordinator = coordinator or os.environ.get("DGEN_COORDINATOR")
    if not coordinator:
        return False
    num_processes = _env_int(num_processes, "DGEN_NUM_PROCESSES", coordinator)
    process_id = _env_int(process_id, "DGEN_PROCESS_ID", coordinator)
    from dgen_tpu_torch.parallel.mesh import default_mesh_shape, init_ranks

    return init_ranks(coordinator, num_processes, process_id, device=device,
                      mesh_shape=default_mesh_shape(num_processes, local_size))


def shard_states_from_env() -> Optional[List[str]]:
    """The per-task state list, if launched through :func:`shard_commands`."""
    raw = os.environ.get("DGEN_SHARD_STATES")
    return [s for s in raw.split(",") if s] if raw else None


def run_with_recovery(sim, checkpoint_dir: str, max_retries: int = 3,
                      **run_kwargs):
    """Run a Simulation with crash recovery: a failed attempt is retried
    from the last per-year checkpoint (a fresh process resumes when
    checkpoints exist). On a multi-rank run there are no retries: after a
    failed collective the group is broken, and a lone rank re-entering
    the run would wait at the next collective, so the error is raised
    and the ranks are restarted together, resuming from the checkpoints."""
    from dgen_tpu_torch.io import checkpoint as ckpt

    user_resume = run_kwargs.pop("resume", None)

    def should_resume(attempt: int) -> bool:
        if attempt > 0:
            return True
        if user_resume is not None:
            return bool(user_resume)
        try:
            return ckpt.latest_year(checkpoint_dir) is not None
        except (FileNotFoundError, OSError):
            return False

    ranks = getattr(sim, "ranks", None)
    retries = max_retries if ranks is None else 0
    last_err = None
    for attempt in range(retries + 1):
        try:
            return sim.run(checkpoint_dir=checkpoint_dir,
                           resume=should_resume(attempt), **run_kwargs)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 - recovery boundary
            last_err = e
            logger.warning("run attempt %d/%d failed: %s", attempt + 1, retries + 1, e)
    raise last_err


#: YearOutputs fields a rank's ``--collect`` file holds (the per-agent
#: ``[N]`` fields; the cash-flow series are the exporter's)
COLLECT_FIELDS = (
    "system_kw", "npv", "payback_period", "first_year_bill_with_system",
    "first_year_bill_without_system", "batt_kw", "batt_kwh", "max_market_share",
    "market_share", "new_adopters", "number_of_adopters", "new_system_kw",
    "system_kw_cum", "market_value", "new_batt_adopters", "batt_adopters_cum",
    "batt_kw_cum", "batt_kwh_cum", "carbon_intensity_t_per_kwh", "avoided_co2_t",
)


def spawn_local_ranks(cmd: Sequence[str], world: int, work: str, *, cwd: str,
                      env: Optional[Dict[str, str]] = None,
                      rank_args: Optional[Dict[int, Sequence[str]]] = None,
                      timeout_s: float = 3600.0) -> List[dict]:
    """``world`` processes of ``cmd`` on this host, on a fresh localhost
    rendezvous (``DGEN_COORDINATOR``, ``DGEN_NUM_PROCESSES``,
    ``DGEN_PROCESS_ID``, and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``: every rank
    is a child here), run in ``cwd`` with ``cwd`` on their ``PYTHONPATH``,
    ``env`` over the inherited environment and ``rank_args[r]`` appended to
    rank r's command; rank r's output goes to ``work/rank<r>.log``. Returns
    each rank's record, the JSON object on its log's last line. When a rank
    fails, or the ranks outlive ``timeout_s``, every rank is stopped and
    RuntimeError names each rank that did not exit 0 with its log's tail."""
    os.makedirs(work, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = {**os.environ, "DGEN_COORDINATOR": f"127.0.0.1:{port}",
            "DGEN_NUM_PROCESSES": str(world), "LOCAL_WORLD_SIZE": str(world),
            "PYTHONPATH": os.pathsep.join(p for p in (cwd, os.environ.get("PYTHONPATH"))
                                          if p),
            **(env or {})}
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(list(cmd) + list((rank_args or {}).get(r, ())), cwd=cwd,
                              env={**base, "DGEN_PROCESS_ID": str(r), "LOCAL_RANK": str(r)},
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t0 > timeout_s):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    recs, failed = [], []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}: {text[-2500:]}")
        else:
            recs.append(json.loads(text.strip().splitlines()[-1]))
    if failed:
        raise RuntimeError(" | ".join(failed))
    return recs


def _parser():
    import argparse

    env = os.environ.get
    p = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.parallel.launch",
        description="one rank of a multi-rank run (DGEN_COORDINATOR, "
                    "DGEN_NUM_PROCESSES, DGEN_PROCESS_ID), or one process "
                    "without them")
    p.add_argument("--preset", default=env("DGEN_PRESET", ""),
                   help="a named preset's world (presets.PRESETS); default: the "
                        "synthetic population of DGEN_SHARD_STATES")
    p.add_argument("--agents", type=int, default=int(env("DGEN_AGENTS", "4096")))
    p.add_argument("--end-year", type=int, default=int(env("DGEN_END_YEAR", "2040")))
    p.add_argument("--seed", type=int, default=None,
                   help="synthetic population seed (default: the shard index)")
    p.add_argument("--pad-multiple", type=int, default=128,
                   help="the table's padding multiple, of the synthetic population "
                        "and of RunConfig.agent_pad_multiple (default 128)")
    p.add_argument("--sizing-iters", type=int, default=None)
    p.add_argument("--econ-years", type=int, default=25)
    p.add_argument("--attachment-rate", type=float, default=None)
    p.add_argument("--with-hourly", action="store_true",
                   help="the state-hourly aggregate (a preset's own setting wins)")
    p.add_argument("--rows-partition", action="store_true",
                   help="split the table into contiguous row blocks "
                        "(RunConfig.partition_by_state=False)")
    p.add_argument("--device", default=env("DGEN_DEVICE", "cuda"))
    p.add_argument("--run-dir", default=env("DGEN_RUN_DIR", ""))
    p.add_argument("--no-export", action="store_true")
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--collect", default="",
                   help="write this rank's per-agent outputs (COLLECT_FIELDS, "
                        "[years, real agents]) and the state-hourly aggregate "
                        "to this .npz")
    p.add_argument("--capture", default="",
                   help="save the operands of this rank's first launch of each "
                        "kernel (cut to --capture-rows rows, on the host) to this "
                        "file (torch.save), to check and time the kernels on them")
    p.add_argument("--capture-rows", type=int, default=8192)
    return p


def _world(args, shard: int, dev):
    """(population, ScenarioConfig, ScenarioInputs, with_hourly, meta) of
    the rank's run: a preset's world, or the synthetic population of the
    shard's states on reference inputs (``DGEN_INPUT_ROOT``, when it is a
    directory) or the uniform synthetic inputs."""
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import ScenarioConfig
    from dgen_tpu_torch.io import synth
    from dgen_tpu_torch.models import scenario as scen

    root = os.environ.get("DGEN_INPUT_ROOT")
    if args.preset:
        return presets.world(args.preset, args.agents, end_year=args.end_year,
                             device=dev, attachment_rate=args.attachment_rate,
                             input_root=root)
    states = shard_states_from_env() or ["DE"]
    cfg = ScenarioConfig(name=f"shard{shard}", start_year=2014,
                         end_year=args.end_year, anchor_years=())
    n_groups = len(synth.STATES) * len(cfg.sectors)
    overrides = (None if args.attachment_rate is None else
                 {"attachment_rate": np.full(n_groups, args.attachment_rate, np.float32)})
    seed = shard if args.seed is None else args.seed
    meta: Dict[str, object] = {"states": list(states)}
    if root and os.path.isdir(root):
        from dgen_tpu_torch.io.reference_inputs import (
            scenario_inputs_from_reference, wholesale_profile_bank)

        inputs, ref_meta = scenario_inputs_from_reference(
            root, cfg, list(synth.STATES), overrides=overrides, device=dev)
        pop = synth.generate_population(args.agents, states=states, seed=seed,
                                        pad_multiple=args.pad_multiple,
                                        n_regions=len(ref_meta["regions"]), device=dev)
        import dataclasses

        import torch

        pop = dataclasses.replace(pop, profiles=dataclasses.replace(
            pop.profiles, wholesale=torch.from_numpy(
                wholesale_profile_bank(ref_meta, root)).to(dev)))
        meta.update(market_curves=ref_meta["market_curves"],
                    data_sources=ref_meta.get("data_sources", {}))
    else:
        pop = synth.generate_population(args.agents, states=states, seed=seed,
                                        pad_multiple=args.pad_multiple, device=dev)
        inputs = scen.uniform_inputs(cfg, n_groups=n_groups, n_regions=pop.n_regions,
                                     overrides=overrides, device=dev)
        meta.update(market_curves={"mms": "synthetic_default",
                                   "bass": "synthetic_default"},
                    data_sources={"all": "synthetic_default"})
    return pop, cfg, inputs, args.with_hourly, meta


@contextlib.contextmanager
def captured_launches(rows: int):
    """Inside the block, the first launch of each bucket-sums kernel
    (``billkernels.CAPTURE``) and the first battery dispatch keep their
    operands, cut to ``rows`` rows, in the yielded dict; the launches run
    as they would."""
    from dgen_tpu_torch.ops import billkernels, dispatch

    cap = billkernels.RowSliceCapture(rows)
    kernel = dispatch.dispatch_battery

    def keep(*args, **kw):
        cap.setdefault("dispatch", args)
        return kernel(*args, **kw)

    billkernels.CAPTURE, dispatch.dispatch_battery = cap, keep
    try:
        yield cap
    finally:
        billkernels.CAPTURE, dispatch.dispatch_battery = None, kernel


def _launch_counts() -> Dict[str, int]:
    from dgen_tpu_torch.ops import billkernels, dispatch

    return {**billkernels.LAUNCHES, "dispatch": dispatch.LAUNCHES["dispatch"]}


def main(argv=None) -> int:
    """One rank's run (``python -m dgen_tpu_torch.parallel.launch``).

    Environment (the JAX package's launch contract): ``DGEN_COORDINATOR``,
    ``DGEN_NUM_PROCESSES``, ``DGEN_PROCESS_ID`` (:func:`initialize_multihost`;
    none of them: one process), ``DGEN_TPU_MESH`` (HxD), ``DGEN_SHARD_INDEX``
    and ``DGEN_SHARD_STATES`` (:func:`shard_commands`), ``DGEN_INPUT_ROOT``,
    ``DGEN_RUN_DIR`` (default ``./runs/shard_<i>``), ``DGEN_AGENTS``,
    ``DGEN_END_YEAR``, ``DGEN_PRESET``, ``DGEN_DEVICE``, and the
    ``DGEN_TPU_*`` switches of ``RunConfig.from_env``. Every rank writes
    its own export parts (``year=<Y>-p<rank>``) and checkpoint parts into
    the shared run directory. The last line of the output is the rank's
    JSON record: its topology and backend, each year's wall, its kernel
    launches, its card's peak memory, and whether ``jax`` or ``dgen_tpu``
    were imported (never)."""
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    import torch

    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.io.export import RunExporter, static_frame_from_table
    from dgen_tpu_torch.io.synth import STATES
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.ops import billkernels, dispatch
    from dgen_tpu_torch.parallel.mesh import RankTopology, shutdown
    from dgen_tpu_torch.presets import year_timer

    topo = initialize_multihost(device=args.device) or RankTopology.single(args.device)
    try:
        shard = int(os.environ.get("DGEN_SHARD_INDEX", "0"))
        run_dir = args.run_dir or f"./runs/shard_{shard}"
        t_start = time.perf_counter()
        pop, cfg, inputs, with_hourly, meta = _world(args, shard, topo.device)
        rc_kw = {"partition_by_state": not args.rows_partition,
                 "agent_pad_multiple": args.pad_multiple}
        if args.sizing_iters:
            rc_kw["sizing_iters"] = args.sizing_iters
        sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                         RunConfig.from_env(**rc_kw), with_hourly=with_hourly,
                         econ_years=args.econ_years, device=topo.device, ranks=topo)
        exporter = None
        if not args.no_export:
            exporter = RunExporter(
                run_dir, agent_id=sim.host_agent_id, mask=sim.host_mask,
                state_names=list(STATES), device=sim.device, ranks=sim.ranks,
                static_frame=(static_frame_from_table(pop.table, states=list(STATES))
                              if sim.ranks is None else None),
                meta={**meta, "scenario": cfg.name, "shard": shard,
                      "distributed": bool(topo.distributed),
                      "n_processes": topo.world_size})
        if topo.device.type == "cuda":
            torch.cuda.synchronize(topo.device)
            torch.cuda.reset_peak_memory_stats(topo.device)
        build_s = time.perf_counter() - t_start
        billkernels.reset_launches()
        dispatch.LAUNCHES["dispatch"] = 0
        year_s: list = []
        t0 = time.perf_counter()
        with year_timer(sim, year_s), (captured_launches(args.capture_rows)
                                       if args.capture else contextlib.nullcontext()) as cap:
            kw = dict(callback=exporter, collect=bool(args.collect))
            if args.no_checkpoint:
                res = sim.run(**kw)
            else:
                res = run_with_recovery(sim, os.path.join(run_dir, "ckpt"), **kw)
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        if args.capture:
            torch.save({k: tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in v)
                        for k, v in cap.items()}, args.capture)
        if args.collect:
            keep = sim.host_mask > 0
            out = {"agent_id": sim.host_agent_id[keep].astype(np.int64),
                   "years": np.asarray(res.years, np.int64)}
            for f in COLLECT_FIELDS:
                out[f] = res.agent[f][:, keep]
            if res.state_hourly_net_mw is not None:
                out["state_hourly_net_mw"] = res.state_hourly_net_mw
            np.savez(args.collect, **out)
        n_real = int((sim.host_mask > 0).sum())
        rec = {
            "rank": topo.rank, "world": topo.world_size, "mesh": list(topo.shape),
            "backend": topo.backend, "device": str(topo.device),
            "agents": n_real, "rows": int(sim.table.n_agents),
            "agent_chunk": sim._agent_chunk, "years": [int(y) for y in res.years],
            "build_s": round(build_s, 3), "run_s": round(run_s, 3),
            "year_s": [round(t, 4) for t in year_s],
            "agent_years_per_s": round(n_real * len(res.years) / max(run_s, 1e-9), 3),
            "launches": launches,
            "max_memory_allocated": (int(torch.cuda.max_memory_allocated(topo.device))
                                     if topo.device.type == "cuda" else None),
            "modeled_step_bytes": int(sim.modeled_step_bytes),
            "imports_jax": sys.modules.get("jax") is not None,
            "imports_dgen_tpu": sys.modules.get("dgen_tpu") is not None,
        }
        print(f"shard {shard} rank {topo.rank}/{topo.world_size}: "
              f"{len(res.years)} years -> {run_dir}")
        print(json.dumps(rec), flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
