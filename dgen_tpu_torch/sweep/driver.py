"""The sweep driver: S scenarios against one copy of the agent table and
profile banks on one card, or on each rank's shard of it (port of
``dgen_tpu/sweep/driver.py``).

The banks and the table are placed once, by the base
:class:`~dgen_tpu_torch.models.simulation.Simulation`, and only the small
``[Y, ...]`` tensors of :class:`~dgen_tpu_torch.models.scenario.
ScenarioInputs` carry a scenario axis. Per planner group
(:mod:`dgen_tpu_torch.sweep.plan`) a sweep runs in one of two modes:

* **vmap mode**: one :func:`sweep_year_step` a model year for the whole
  group. PyTorch's ``torch.func.vmap`` cannot carry a call into the
  port's CUDA kernels (they have no batching rule), so the scenario axis
  is explicit: each scenario's year inputs, NEM gate and every reduction
  across rows (the state sums of last year's capacity, the market step,
  the battery allocation, the state-hourly aggregate) run on its own
  ``[N]`` rows, and the per-row work runs once for the group: each
  chunk's sizing, and each chunk's hourly remat pass, sees the S
  scenarios' rows side by side, S x chunk rows a kernel launch
  (:func:`~dgen_tpu_torch.models.simulation.scenario_years`). A row's
  result does not depend on how many rows share its launch, so each
  scenario's outputs equal its loop-mode run's and its own
  ``Simulation.run``'s bit for bit;
* **loop mode**: scenario-major, each scenario's
  :meth:`~dgen_tpu_torch.models.simulation.Simulation.with_inputs`
  sibling runs the single-scenario year step over the shared table and
  banks, the memory bounded by the single-scenario chunk.

On several ranks (``ranks=``, a ``parallel.mesh.RankTopology`` of more
than one rank; every rank constructs the sweep and runs it) every group
runs the scenario-major loop: each scenario steps the multi-rank year
step over the rank's shard (``Simulation(ranks=)``), its exports and
checkpoints one part a rank, and at the end each scenario's per-agent
results are gathered over the ranks, rank by rank, with their agent ids
(``SweepResults.host_agent_id``): every agent's values equal the
single-process sweep's bit for bit.

Not ported: the retrace guard (``guard_retrace``, ``ROADMAP.md`` item
12: PyTorch compiles nothing to retrace).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig, resolve_device
from dgen_tpu_torch.io import hostio
from dgen_tpu_torch.models.scenario import ScenarioInputs, ScenarioStack, stack_scenarios
from dgen_tpu_torch.models.simulation import (
    _PERSISTENT_ROW_BYTES,
    SimCarry,
    SimResults,
    Simulation,
    YearOutputs,
    scenario_years,
)
from dgen_tpu_torch.resilience.faults import fault_point
from dgen_tpu_torch.sweep.plan import MODE_VMAP, ScenarioGroup, SweepPlan, plan_sweep
from dgen_tpu_torch.sweep.results import SweepResults
from dgen_tpu_torch.tree import leaf_paths, tree_map
from dgen_tpu_torch.utils import timing

logger = logging.getLogger(__name__)


def unstack_one(tree, j: int):
    """Member ``j`` of a tree of ``[S, ...]`` leaves (views)."""
    return tree_map(lambda leaf: leaf[j], tree)


def unstack(tree, s: int) -> list:
    """The S members of a tree of ``[S, ...]`` leaves (views)."""
    return [unstack_one(tree, j) for j in range(s)]


def stack(trees: list):
    """One tree of ``[S, ...]`` leaves from S trees of the same shapes."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def sweep_year_step(table, profiles, tariffs, inputs_s: ScenarioInputs, carry: SimCarry,
                    year_idx: int, **static):
    """One model year of S scenarios: ``inputs_s`` and ``carry`` hold
    ``[S, ...]`` leaves; returns the ``[S, ...]`` carry and
    :class:`YearOutputs` (``state_hourly_net_mw`` ``[S, n_states, 8760]``,
    or ``[S, 0, 0]``). The static keywords are ``year_step``'s. Every
    scenario's rows are sized in the same launches, S x chunk rows each,
    and every reduction across rows runs per scenario
    (:func:`~dgen_tpu_torch.models.simulation.scenario_years`)."""
    s = int(inputs_s.pv_capex_per_kw.shape[0])
    carries, outs = scenario_years(table, profiles, tariffs, unstack(inputs_s, s),
                                   unstack(carry, s), year_idx, **static)
    return stack(carries), stack(outs)


def group_step_kwargs(base: Simulation, net_billing: bool, first_year: bool) -> dict:
    """The static keywords and cluster operands of a group's
    :func:`sweep_year_step` (or an ensemble's): ``base``'s, with the
    net-billing flag pinned, on every cluster too, so the group's
    scenarios run one set of static arguments."""
    kw = base.step_kwargs(first_year)
    kw["net_billing"] = net_billing
    if kw.get("cluster") is not None:
        kw["cluster"] = kw["cluster"].pin_net_billing(net_billing)
    kw.update(base.step_operands())
    return kw


def stacked_carry(base: Simulation, s: int) -> SimCarry:
    """The zero carry of S scenarios over ``base``'s table, ``[S, N]``
    leaves."""
    return stack([base.init_carry() for _ in range(s)])


def bank_nbytes(profiles) -> int:
    """Bytes of the profile banks on the card: what a sweep uploads once
    instead of S times (``bank_bytes_shared``)."""
    return int(sum(t.numel() * t.element_size() for t in leaf_paths(profiles).values()))


def agent_fields() -> List[str]:
    """The per-agent :class:`YearOutputs` fields a run collects."""
    return [f.name for f in dataclasses.fields(YearOutputs)
            if f.name != "state_hourly_net_mw"]


def collect_year(outs, collected: Dict[str, list], hourly: Optional[list]) -> None:
    """One year's per-agent outputs (and state-hourly aggregate, where
    ``hourly`` is a list) fetched and appended, the serialized way."""
    fetch = {k: getattr(outs, k) for k in collected}
    if hourly is not None:
        fetch["_hourly"] = outs.state_hourly_net_mw
    host = hostio.to_host(fetch)
    for k in collected:
        collected[k].append(np.array(host[k]))
    if hourly is not None:
        hourly.append(np.array(host["_hourly"]))


class _ScenarioExport(hostio.ExportConsumer):
    """The host-I/O pipeline's export stage for scenario ``j`` of a
    vmap-mode group: the exporter's split protocol on the scenario's
    slice of the stacked year outputs."""

    def __init__(self, exporter, j: int) -> None:
        super().__init__(exporter)
        self.j = j
        self.name = f"export{j}"

    def device_payload(self, year, year_idx, outs, carry):
        return super().device_payload(year, year_idx, unstack_one(outs, self.j), carry)


class SweepSimulation:
    """Run S scenarios against one shared population (the sweep
    analogue of :class:`Simulation`).

    ``scenarios``: S ScenarioInputs (or a ScenarioStack) sharing the
    static grid (a mismatch raises ScenarioStackError naming the field);
    ``scenario``: the ScenarioConfig common to all; ``labels``:
    per-scenario names (default ``scn0..scnS-1``), stamped into exports
    and checkpoint subdirectories; ``baseline``: the delta report's
    reference scenario; ``plan``: a precomputed SweepPlan (default:
    :func:`plan_sweep` on the card's memory); ``max_vmap_scenarios``:
    the planner's width cap. ``ranks``: the run's
    ``parallel.mesh.RankTopology``; on more than one rank the sweep runs
    on this rank's shard (module docstring), on the rank's device. Other
    parameters are Simulation's.
    """

    def __init__(
        self,
        table,
        profiles,
        tariffs,
        scenarios: Union[Sequence[ScenarioInputs], ScenarioStack],
        scenario: ScenarioConfig,
        run_config: Optional[RunConfig] = None,
        with_hourly: bool = False,
        econ_years: int = 25,
        labels: Optional[Sequence[str]] = None,
        baseline: int = 0,
        plan: Optional[SweepPlan] = None,
        max_vmap_scenarios: Optional[int] = None,
        device="cuda",
        ranks=None,
    ) -> None:
        #: the run's rank topology when it has more than one rank, else None
        self.ranks = ranks if ranks is not None and ranks.distributed else None
        if self.ranks is not None:
            device = self.ranks.device
        if isinstance(scenarios, ScenarioStack):
            members = [scenarios.scenario(i) for i in range(scenarios.n_scenarios)]
        else:
            members = list(scenarios)
        if not members:
            raise ValueError("sweep needs at least one scenario")
        self.device = resolve_device(device)
        self.members = members
        self.scenario = scenario
        self.run_config = run_config or RunConfig()
        self.with_hourly = with_hourly
        self.labels = (list(labels) if labels is not None
                       else [f"scn{i}" for i in range(len(members))])
        if len(self.labels) != len(members):
            raise ValueError(f"{len(self.labels)} labels for {len(members)} scenarios")
        if not 0 <= baseline < len(members):
            raise ValueError(f"baseline index {baseline} out of range")
        self.baseline = baseline
        rc = self.run_config
        self.plan = plan if plan is not None else plan_sweep(
            members, list(scenario.model_years), table=table, tariffs=tariffs,
            with_hourly=with_hourly, econ_years=econ_years,
            sizing_iters=rc.sizing_iters, bank_bf16=rc.bf16_banks,
            bank_quant=rc.quant_banks, max_vmap_scenarios=max_vmap_scenarios,
            cluster=rc.cluster_tariffs, agent_pad_multiple=rc.agent_pad_multiple,
            device=self.device, mesh=self.ranks,
        )
        # the base Simulation does the one-time work (validation, flags,
        # daylight layout, narrowed banks, padding, cluster layout,
        # placement) with the planner's S-aware chunk, so a vmap group's
        # S x chunk rows fit
        if self.ranks is not None and any(g.mode == MODE_VMAP for g in self.plan.groups):
            raise ValueError("a sweep on several ranks runs the scenario-major loop: "
                             "a vmap group cannot be planned for it")
        if self.plan.agent_chunk is not None and rc.agent_chunk is None:
            rc = dataclasses.replace(rc, agent_chunk=self.plan.agent_chunk)
        self.base = Simulation(table, profiles, tariffs, members[baseline], scenario, rc,
                               with_hourly=with_hourly, econ_years=econ_years,
                               device=self.device, ranks=self.ranks)
        self.years = self.base.years
        #: bytes of profile bank on the card, uploaded once for the sweep;
        #: every sibling shares the same tensors
        self.bank_bytes_shared = bank_nbytes(self.base.profiles)
        nb_of = {i: g.net_billing for g in self.plan.groups for i in g.indices}
        on_card = self.device.type == "cuda"
        before = torch.cuda.memory_allocated(self.device) if on_card else 0
        #: one sibling a scenario (loop mode runs these; vmap mode reads
        #: their inputs), each sharing the base's table, banks, tariffs,
        #: daylight layout, chunk and cluster layout; net_billing pinned
        #: per group
        self.sims: List[Simulation] = [
            self.base.with_inputs(m, net_billing=nb_of[i], timing_ctx=self.labels[i])
            for i, m in enumerate(members)
        ]
        #: bytes the siblings added on the card (their inputs where they
        #: were elsewhere; never a bank); None off a card
        self.sibling_bytes = (torch.cuda.memory_allocated(self.device) - before
                              if on_card else None)
        if self.plan.hbm_bytes is not None:
            logger.info("sweep memory budget: %.2f GiB card, %d bytes/agent-row modeled",
                        self.plan.hbm_bytes / 1024**3, self.plan.per_agent_bytes)
        for g in self.plan.groups:
            logger.info("sweep group (%d scenario(s), net_billing=%s): %s mode",
                        g.n_scenarios, g.net_billing, g.mode)
        #: shared io.hostio.HostIOPool for the duration of run()
        self._pool = None
        #: per-group (vmap) or per-scenario (loop) pipeline stats of the
        #: last run (empty when it serialized)
        self.hostio_stats: Dict[str, dict] = {}

    @property
    def n_scenarios(self) -> int:
        return len(self.members)

    def modeled_step_bytes(self, group: ScenarioGroup) -> int:
        """Modeled peak bytes of one year step of ``group``: its batched
        rows of one chunk (S x chunk in vmap mode, one scenario's chunk in
        loop mode) beside the S-wide persistent rows."""
        n = self.base.table.n_agents
        w = group.n_scenarios if group.mode == MODE_VMAP else 1
        rows = self.base._agent_chunk or n
        return (self.base._per_agent_bytes * w * rows
                + group.n_scenarios * n * _PERSISTENT_ROW_BYTES)

    # -- vmap mode ------------------------------------------------------

    def group_inputs(self, group: ScenarioGroup) -> ScenarioInputs:
        """``group``'s inputs stacked, ``[S, ...]`` leaves on the card."""
        return stack_scenarios([self.sims[i].inputs for i in group.indices]).inputs

    def _exporter(self, run_dir: str, i: int):
        from dgen_tpu_torch.io.export import RunExporter

        rep_q = self.base.quarantine_report
        quarantine = rep_q.summary() if rep_q is not None and not rep_q.is_clean else None
        return RunExporter(os.path.join(run_dir, f"scenario={self.labels[i]}"),
                           self.base.host_agent_id, self.base.host_mask, device=self.device,
                           meta=scenario_meta(self.labels, i, self.baseline, quarantine),
                           ranks=self.ranks)

    def _run_group_vmap(self, group: ScenarioGroup, collect: bool,
                        checkpoint_dir: Optional[str], resume: bool, label: str,
                        run_dir: Optional[str]) -> Dict[int, SimResults]:
        from dgen_tpu_torch.io import checkpoint as ckpt

        s = group.n_scenarios
        base = self.base
        inputs_s = self.group_inputs(group)
        kwargs = group_step_kwargs(base, group.net_billing, first_year=True)
        carry = stacked_carry(base, s)
        rows = base.checkpoint_rows
        start_idx = 0
        if resume:
            if not checkpoint_dir:
                raise ValueError("resume=True requires checkpoint_dir")
            last = ckpt.latest_year(checkpoint_dir, scenario=label)
            if last is not None and last not in self.years:
                raise ValueError(
                    f"checkpointed year {last} is not on this sweep's year grid "
                    f"{self.years}; refusing to resume")
            if last is not None:
                _, carry = ckpt.restore_year(checkpoint_dir, base.table.n_agents, last,
                                             device=self.device, rows=rows,
                                             scenario=label, n_scenarios=s)
                start_idx = self.years.index(last) + 1
                logger.info("sweep %s: resuming after year %d (index %d)", label, last,
                            start_idx)
        writer = (ckpt.Writer(checkpoint_dir, rows=rows, scenario=label)
                  if checkpoint_dir is not None else None)
        exporters = ([self._exporter(run_dir, i) for i in group.indices]
                     if run_dir is not None else [])
        fields = agent_fields()
        rc = self.run_config
        async_io = (rc.async_io_enabled and not rc.debug_invariants
                    and (collect or writer is not None or bool(exporters)))
        collector = None
        consumers: list = []
        if async_io:
            if collect:
                collector = hostio.CollectConsumer(fields, self.with_hourly)
                consumers.append(collector)
            consumers += [_ScenarioExport(e, j) for j, e in enumerate(exporters)]
            if writer is not None:
                consumers.append(hostio.CheckpointConsumer(writer))
        collected: Dict[str, list] = {k: [] for k in fields}
        hourly: List[np.ndarray] = []
        pipeline = None
        loop_failed = False
        try:
            for yi, year in enumerate(self.years):
                if yi < start_idx:
                    continue
                kwargs["first_year"] = yi == 0
                with timing.timer("sweep_year_step", ctx=label):
                    carry, outs = sweep_year_step(base.table, base.profiles, base.tariffs,
                                                  inputs_s, carry, yi, **kwargs)
                    if not async_io:
                        base._sync()
                if async_io:
                    if pipeline is None:
                        pipeline = hostio.pipeline_for(
                            consumers, outs, carry=carry if writer is not None else None,
                            timing_ctx=label, pool=self._pool)
                    snap = hostio.snapshot_carry(carry) if writer is not None else None
                    pipeline.submit(year, yi, outs, carry=snap)
                    del snap
                else:
                    for j, e in enumerate(exporters):
                        e(year, yi, unstack_one(outs, j))
                    if writer is not None:
                        with timing.timer("ckpt_save", ctx=label):
                            writer.save(year, carry)
                    if collect:
                        collect_year(outs, collected, hourly if self.with_hourly else None)
                del outs
        except BaseException:
            loop_failed = True
            raise
        finally:
            try:
                if pipeline is not None:
                    self.hostio_stats[label] = pipeline.drain(failed=loop_failed)
            finally:
                if writer is not None:
                    writer.close()
        if async_io:
            with timing.timer("device_drain", ctx=label):
                base._sync()
        if collector is not None:
            collected, hourly = collector.collected, collector.hourly

        run_years = self.years[start_idx:]
        out: Dict[int, SimResults] = {}
        for j, idx in enumerate(group.indices):
            agent = ({k: np.stack([v[j] for v in vs]) for k, vs in collected.items()}
                     if collect and collected[fields[0]] else {})
            out[idx] = SimResults(
                years=list(run_years), agent=agent,
                state_hourly_net_mw=np.stack([h[j] for h in hourly]) if hourly else None)
        return out

    # -- loop mode ------------------------------------------------------

    def _run_group_loop(self, group: ScenarioGroup, collect: bool,
                        checkpoint_dir: Optional[str], resume: bool,
                        run_dir: Optional[str]) -> Dict[int, SimResults]:
        from dgen_tpu_torch.io import checkpoint as ckpt

        out: Dict[int, SimResults] = {}
        for idx in group.indices:
            # fault site: a scenario dying between the scenarios of a
            # loop-mode group; a retry with resume re-enters at (scenario,
            # year) through the per-scenario checkpoint layout
            fault_point("sweep_scenario")
            sim = self.sims[idx]
            scn_ckpt = (ckpt.scenario_dir(checkpoint_dir, self.labels[idx])
                        if checkpoint_dir else None)
            callback = self._exporter(run_dir, idx) if run_dir is not None else None
            out[idx] = sim.run(callback=callback, collect=collect,
                               checkpoint_dir=scn_ckpt, resume=resume)
            if sim.hostio_stats is not None:
                self.hostio_stats[self.labels[idx]] = sim.hostio_stats
        return out

    # -- the sweep ------------------------------------------------------

    def run(self, collect: bool = True, checkpoint_dir: Optional[str] = None,
            resume: bool = False, *, run_dir: Optional[str] = None) -> SweepResults:
        """Run every scenario of every planner group.

        ``checkpoint_dir`` lays out per-scenario subdirectories
        (``scn=<label>/`` in loop mode, one stacked ``scn=group<g>/`` per
        vmap group), so ``resume=True`` continues a killed sweep at
        (scenario, year). ``run_dir`` writes each scenario's surfaces as
        its years finish (``io.export.RunExporter`` under
        ``scenario=<label>/``, with :meth:`SweepResults.export`'s meta
        stamps), so the files of a killed and resumed sweep are those of a
        clean one;
        :meth:`SweepResults.export` writes collected results afterwards.

        Host consumers ride the host-I/O pipeline (``io.hostio``) as in
        single runs, every scenario's pipeline on one shared worker pair;
        ``RunConfig.async_host_io=False`` serializes, and
        :attr:`hostio_stats` holds the pipelines' stats afterwards."""
        self.hostio_stats = {}
        rc = self.run_config
        pool = None
        if (rc.async_io_enabled and not rc.debug_invariants
                and (collect or checkpoint_dir is not None or run_dir is not None)):
            pool = hostio.HostIOPool()
        self._pool = pool
        for sim in self.sims:
            sim._hostio_pool = pool
        results: Dict[int, SimResults] = {}
        try:
            for gi, group in enumerate(self.plan.groups):
                if group.mode == MODE_VMAP:
                    results.update(self._run_group_vmap(
                        group, collect, checkpoint_dir, resume, f"group{gi}", run_dir))
                else:
                    results.update(self._run_group_loop(
                        group, collect, checkpoint_dir, resume, run_dir))
        finally:
            self._pool = None
            for sim in self.sims:
                sim._hostio_pool = None
            if pool is not None:
                pool.close()
        rep_q = self.base.quarantine_report
        runs = [results[i] for i in range(self.n_scenarios)]
        mask, ids = self.base.host_mask, self.base.host_agent_id
        if self.ranks is not None:
            runs, mask, ids = gather_ranks(self.ranks, runs, mask, ids)
        return SweepResults(
            labels=list(self.labels),
            baseline=self.baseline,
            runs=runs,
            plan=self.plan,
            bank_bytes_shared=self.bank_bytes_shared,
            host_mask=mask,
            host_agent_id=ids,
            quarantine=(rep_q.summary()
                        if rep_q is not None and not rep_q.is_clean else None),
        )


def _gather_rows(ranks, x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Every rank's ``x`` (rows on ``axis``, equal shapes), concatenated on
    that axis in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, axis, 0)))
    return np.moveaxis(ranks.all_gather(t).numpy(), 0, axis)


def gather_ranks(ranks, runs: List[SimResults], host_mask: np.ndarray,
                 host_agent_id: np.ndarray) -> tuple:
    """(runs, host_mask, host_agent_id) over every rank's rows, rank by
    rank: each run's per-agent ``[Y, N]`` arrays gathered over the ranks
    (a collective: every rank calls it; rows are their second axis), the
    state-hourly aggregate (the same on every rank) kept as it is."""
    out = []
    for r in runs:
        agent = {k: _gather_rows(ranks, v, axis=1) for k, v in sorted(r.agent.items())}
        out.append(dataclasses.replace(r, agent=agent))
    return (out, _gather_rows(ranks, np.asarray(host_mask)),
            _gather_rows(ranks, np.asarray(host_agent_id)))


def scenario_meta(labels: Sequence[str], i: int, baseline: int, quarantine) -> dict:
    """The meta.json stamps of scenario ``i``'s export directory, as the
    JAX package's sweep export stamps them."""
    return {
        "scenario": labels[i],
        "scenario_index": i,
        "sweep_baseline": labels[baseline],
        "sweep_n_scenarios": len(labels),
        **({"quarantine": quarantine} if quarantine else {}),
    }
