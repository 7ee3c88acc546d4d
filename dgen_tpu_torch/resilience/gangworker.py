"""One rank of a supervised gang (port of
``dgen_tpu/resilience/gangworker.py``;
``python -m dgen_tpu_torch.resilience.gangworker``).

Started by the :class:`~dgen_tpu_torch.resilience.gang.GangSupervisor`
(or by an operator reproducing its env contract, the gang module's
docstring). Per rank it:

* starts its rank of the process group through
  :func:`dgen_tpu_torch.parallel.launch.initialize_multihost`
  (``DGEN_COORDINATOR`` / ``DGEN_NUM_PROCESSES`` / ``DGEN_PROCESS_ID``,
  ``DGEN_PLATFORM`` the rank's device, ``DGEN_CPU_DEVICES`` ranks per
  host) and :func:`dgen_tpu_torch.parallel.mesh.init_ranks`;
* builds the same world on every rank, a pure function of the env: a
  named preset's (``DGEN_PRESET``), the national generator's
  (``DGEN_GANG_WORLD=national``, :mod:`dgen_tpu_torch.models.synth`) or
  the small synthetic population of ``DGEN_GANG_STATES``; the
  Simulation then keeps this rank's shard of it;
* resumes from the supervisor's manifest frontier: the newest
  checkpoint that restores onto this rank's rows at or below it
  (:func:`dgen_tpu_torch.parallel.elastic.resume_year_for`, by agent id,
  so a P -> P' relaunch restores a year written by P ranks);
* exports its own rows a year, recorded in its shard ledger
  (:class:`~dgen_tpu_torch.resilience.manifest.RunManifest` with
  ``shard=rank``; completeness is decided by the
  :class:`~dgen_tpu_torch.resilience.manifest.GangManifest` merge), and
  heartbeats after each year (the supervisor's stall check reads the
  file's freshness);
* on SIGTERM (or ``DGEN_GANG_STOP_AFTER``) runs the **synchronized stop
  barrier** (:class:`StopFlag`): a per-year ``RankTopology.max_int`` of
  every rank's flag, so all ranks agree on the save year and each exports
  and checkpoints through it before it exits;
* writes its done file: years run, whether it stopped early, its chunk,
  its kernel launches, its card's peak allocated bytes beside its budget
  (the share of the card its chunk was planned for); with
  ``DGEN_GANG_CAPTURE`` it saves its first launches' operands there
  (``DGEN_GANG_CAPTURE_ROWS`` rows, ``parallel.launch.captured_launches``).

With no coordinator in the env it refuses to run; with no card and no
``DGEN_PLATFORM=cpu`` the rank's device raises rather than fall back.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import sys

from dgen_tpu_torch.resilience.faults import fault_point

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


class StopFlag:
    """The synchronized stop barrier. A local stop request (SIGTERM from
    the supervisor, or the deterministic ``DGEN_GANG_STOP_AFTER`` drill
    knob) becomes a gang-wide stop through a per-year ``max_int`` of every
    rank's flag, evaluated once a year by every rank, so all ranks agree
    on the save year even when only one of them got the signal."""

    def __init__(self, stop_after: int | None = None, ranks=None) -> None:
        self.stop_after = stop_after
        self.ranks = ranks
        self.preempted = False
        self._sigterm = False

    def install(self) -> "StopFlag":
        signal.signal(signal.SIGTERM, self._on_sigterm)
        return self

    def _on_sigterm(self, *_args) -> None:
        self._sigterm = True

    def local(self, year: int) -> bool:
        return self._sigterm or (self.stop_after is not None and year >= self.stop_after)

    def should_stop(self, year: int, year_idx: int) -> bool:
        """``Simulation.run``'s per-year hook, called by every rank after
        the year's exports and checkpoint are issued. It holds a
        collective: every rank calls it once a year it runs."""
        # fault site: the barrier failing (a rank dying between the year
        # step and the barrier is a gang death; the supervisor relaunches)
        fault_point("gang_barrier")
        flag = 1 if self.local(year) else 0
        stop = (self.ranks.max_int(flag) if self.ranks is not None else flag) > 0
        if stop:
            self.preempted = True
        return stop


class _GangExport:
    """The rank's year callback: the exporter (on the host-I/O pipeline's
    split protocol, or called as it is on the serialized path) with the
    kill fault site before its writes and the heartbeat after them."""

    def __init__(self, exporter, hb_path: str) -> None:
        self.exporter = exporter
        self.hb_path = hb_path

    def _beat(self, year: int, year_idx: int) -> None:
        from dgen_tpu_torch.resilience.gang import write_heartbeat

        write_heartbeat(self.hb_path, pid=os.getpid(), year=int(year),
                        year_idx=int(year_idx))

    def prepare(self, year, year_idx, outs) -> None:
        self.exporter.prepare(year, year_idx, outs)

    def __call__(self, year, year_idx, outs) -> None:
        # fault site: a ``kill`` here is a rank dying mid-year with
        # collectives in flight; the supervisor must tear the whole gang
        # down and relaunch it from the frontier
        fault_point("gang_worker_kill")
        self.exporter(year, year_idx, outs)
        self._beat(year, year_idx)

    def device_payload(self, year, year_idx, outs):
        return self.exporter.device_payload(year, year_idx, outs)

    def write_host(self, year, year_idx, host) -> None:
        fault_point("gang_worker_kill")
        self.exporter.write_host(year, year_idx, host)
        self._beat(year, year_idx)

    def stamp_hostio(self, stats) -> None:
        self.exporter.stamp_hostio(stats)


def build_world(device):
    """(population, ScenarioConfig, ScenarioInputs, with_hourly,
    RunConfig) of the gang's run from the env, the same on every rank."""
    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.models import scenario as scen

    end_year = _env_int("DGEN_END_YEAR", 2016)
    preset = os.environ.get("DGEN_PRESET", "").strip()
    iters = os.environ.get("DGEN_GANG_SIZING_ITERS", "").strip()
    if preset:
        from dgen_tpu_torch import presets

        pop, cfg, inputs, with_hourly, _ = presets.world(
            preset, _env_int("DGEN_AGENTS", 0) or None, end_year=end_year, device=device)
        rc = RunConfig.from_env(**({"sizing_iters": int(iters)} if iters else {}))
        return pop, cfg, inputs, with_hourly, rc
    cfg = ScenarioConfig(name=os.environ.get("DGEN_GANG_NAME", "gang"),
                         start_year=_env_int("DGEN_GANG_START_YEAR", 2014),
                         end_year=end_year, anchor_years=())
    if os.environ.get("DGEN_GANG_WORLD", "") == "national":
        from dgen_tpu_torch.models import synth as national

        pop = national.generate_world(national.NationalSpec(
            n_agents=_env_int("DGEN_AGENTS", 10_240), seed=_env_int("DGEN_GANG_SEED", 11),
            tariff_mix=os.environ.get("DGEN_GANG_TARIFF_MIX", "mixed")), device=device)
    else:
        from dgen_tpu_torch.io import synth

        states = [s for s in os.environ.get("DGEN_GANG_STATES", "DE,CA").split(",") if s]
        pop = synth.generate_population(_env_int("DGEN_AGENTS", 96), states=states,
                                        seed=_env_int("DGEN_GANG_SEED", 11),
                                        pad_multiple=64, device=device)
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, device=device)
    rc = RunConfig.from_env(sizing_iters=int(iters) if iters else 6)
    return pop, cfg, inputs, False, rc


def main() -> int:
    import time

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    from dgen_tpu_torch.resilience import faults
    from dgen_tpu_torch.resilience.gang import done_path, heartbeat_path, write_heartbeat

    # per-rank fault arming (drills set DGEN_TPU_FAULTS on chosen ranks
    # and incarnations through the supervisor's env_for)
    faults.install_from_env()
    # the SIGTERM flag is live before the bring-up: the supervisor may
    # forward a pending stop within one poll of the spawn, and the default
    # disposition would kill a booting rank instead of letting it reach
    # its first stop barrier
    stop = StopFlag(stop_after=(_env_int("DGEN_GANG_STOP_AFTER", 0) or None)).install()

    gang_dir = os.environ.get("DGEN_GANG_DIR", "")
    run_dir = os.environ.get("DGEN_RUN_DIR", "")
    if not (gang_dir and run_dir and os.environ.get("DGEN_COORDINATOR")):
        raise ValueError(
            "gangworker needs the gang env (DGEN_COORDINATOR, DGEN_NUM_PROCESSES, "
            "DGEN_PROCESS_ID, DGEN_GANG_DIR, DGEN_RUN_DIR): it is started by "
            "resilience.gang.GangSupervisor, not by hand")
    index = _env_int("DGEN_PROCESS_ID", 0)
    hb_path = heartbeat_path(gang_dir, index)
    # the boot heartbeat (no year yet): the supervisor's boot grace runs
    # until the first year heartbeat
    write_heartbeat(hb_path, pid=os.getpid(), phase="boot")

    import numpy as np
    import torch

    from dgen_tpu_torch.io.export import RunExporter
    from dgen_tpu_torch.io.synth import STATES
    from dgen_tpu_torch.models.simulation import (
        _MEMORY_BUDGET_FRAC, Simulation, rank_memory_bytes)
    from dgen_tpu_torch.ops import billkernels, dispatch
    from dgen_tpu_torch.parallel import elastic
    from dgen_tpu_torch.parallel.launch import captured_launches, initialize_multihost
    from dgen_tpu_torch.parallel.mesh import RankTopology, shutdown
    from dgen_tpu_torch.resilience.manifest import RunManifest
    from dgen_tpu_torch.utils.atomic import atomic_write_json

    platform = os.environ.get("DGEN_PLATFORM", "").strip() or "cuda"
    local = _env_int("DGEN_CPU_DEVICES", 0) or None
    topo = initialize_multihost(device=platform, local_size=local)
    if topo is False:
        raise ValueError("gangworker needs DGEN_COORDINATOR")
    try:
        n_proc = topo.world_size
        if topo.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(topo.device)
        pop, cfg, inputs, with_hourly, rc = build_world(topo.device)
        sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                         with_hourly=with_hourly,
                         econ_years=_env_int("DGEN_GANG_ECON_YEARS", 25),
                         device=topo.device, ranks=topo)
        del pop
        n_padded = int(sim.table.n_agents) * n_proc
        manifest = RunManifest(run_dir, shard=index, n_processes=n_proc)
        exporter = RunExporter(
            run_dir, agent_id=sim.host_agent_id, mask=sim.host_mask,
            state_names=list(STATES), device=sim.device, ranks=sim.ranks,
            manifest=manifest,
            # topology-invariant artifacts: a multi-rank run's parts are
            # float32, so a P' = 1 resume must not quantize its exports
            compact=False,
            meta={"gang": {"n_processes": n_proc, "process": index,
                           # the padded global table size a later restore
                           # on another topology needs
                           "n_agents_padded": n_padded}})
        rep_q = sim.quarantine_report
        if rep_q is not None and not rep_q.is_clean:
            if index == 0:
                rep_q.save(os.path.join(run_dir, "quarantine.json"))
            exporter.stamp_quarantine(rep_q.summary())

        ckpt_dir = os.environ.get("DGEN_GANG_CKPT_DIR",
                                  os.path.join(run_dir, "checkpoints"))
        raw = os.environ.get("DGEN_GANG_FRONTIER", "").strip()
        frontier = int(raw) if raw else None
        resume_year = (elastic.resume_year_for(
            ckpt_dir, n_padded, frontier, topo=sim.ranks, device=sim.device,
            rows=lambda y: sim.restore_rows(ckpt_dir, y))
            if os.path.isdir(ckpt_dir) else None)
        # every rank re-enters at rank 0's year
        resume_year = topo.broadcast(torch.tensor(
            [-1 if resume_year is None else resume_year], dtype=torch.int64))[0].item()
        resume_year = None if resume_year < 0 else int(resume_year)
        if resume_year is not None:
            logger.info("gang rank %d/%d: resuming after year %d (frontier %s)",
                        index, n_proc, resume_year, frontier)
        stop.ranks = topo
        cap_path = os.environ.get("DGEN_GANG_CAPTURE", "").strip()
        billkernels.reset_launches()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with (captured_launches(_env_int("DGEN_GANG_CAPTURE_ROWS", 8192))
              if cap_path else contextlib.nullcontext()) as cap:
            res = sim.run(callback=_GangExport(exporter, hb_path), collect=False,
                          checkpoint_dir=ckpt_dir, resume=resume_year is not None,
                          resume_year=resume_year, should_stop=stop.should_stop)
        run_s = time.perf_counter() - t0
        if cap_path:
            torch.save({k: tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in v)
                        for k, v in cap.items()}, cap_path)
        share = rank_memory_bytes(sim.device, sim.ranks)
        atomic_write_json(done_path(gang_dir, index), {
            "process": index, "n_processes": n_proc,
            "years_run": [int(y) for y in res.years],
            "completed_through": (int(res.years[-1]) if res.years else resume_year),
            "resumed_after": resume_year,
            "preempted": stop.preempted,
            "device": str(sim.device), "backend": topo.backend,
            "agents": int((np.asarray(sim.host_mask) > 0).sum()),
            "rows": int(sim.table.n_agents), "agent_chunk": sim._agent_chunk,
            "run_s": round(run_s, 4),
            "launches": {**billkernels.LAUNCHES, **dispatch.LAUNCHES},
            "max_memory_allocated": (int(torch.cuda.max_memory_allocated(sim.device))
                                     if sim.device.type == "cuda" else None),
            "card_share_bytes": share,
            "memory_budget_bytes": (int(share * _MEMORY_BUDGET_FRAC)
                                    if share is not None else None),
            "modeled_step_bytes": int(sim.modeled_step_bytes),
            "imports_jax": sys.modules.get("jax") is not None,
            "imports_dgen_tpu": sys.modules.get("dgen_tpu") is not None,
        })
        print(f"gang rank {index}/{n_proc}: {len(res.years)} years -> {run_dir}"
              + (" (preempted)" if stop.preempted else ""), flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
