"""The ensemble driver: E Monte-Carlo members against one placed table
and one copy of the banks on the card (or each rank's shard of it), with
dynamic cohort populations (port of ``dgen_tpu/ensemble/driver.py``).

It rides the sweep engine: :func:`~dgen_tpu_torch.sweep.plan.plan_sweep`
budgets the member axis through its ``n_members`` term, and execution
is the same pair of modes:

* **vmap mode**: :func:`ensemble_year_step` is the sweep's
  :func:`~dgen_tpu_torch.sweep.driver.sweep_year_step` over the member
  axis, with the year's alive mask ``mask * (entry_year <= year)``
  formed once ahead of it when cohorts are scheduled (the members share
  one population): each chunk's sizing sees the E members' rows side by
  side, every reduction across rows runs per member;
* **loop mode**: member-major over ``with_inputs`` siblings. E = 1 is
  pinned to it, and a zero-width member with no cohorts steps the base
  Simulation itself, so a zero-draw E = 1 ensemble equals
  ``Simulation.run`` bit for bit.

Per-year statistics reduce on the card (:mod:`~dgen_tpu_torch.ensemble.
stats`): vmap mode fetches ``[Q]``-sized quantile blocks, loop mode one
scalar block a (member, year). Checkpoints are (member, year)-grained:
loop mode in ``mem=<mmm>/`` subdirectories, vmap mode one stacked
``[E, N]`` carry a year in ``scn=members/``; the partial statistics ride
the checkpoint directory as a JSON sidecar (:data:`STATS_FILE`), so a
resumed run reports the full horizon, and a sidecar of another
configuration (mode, E, quantiles) is ignored.

On several ranks (``ranks=``, a ``parallel.mesh.RankTopology``; every
rank constructs and runs the ensemble) it runs member-major loop mode
over each rank's shard: each member steps the multi-rank year step, its
per-member aggregates are summed over the ranks before the host fetch,
its checkpoints are one part a rank, and the members' per-agent results
are gathered over the ranks with their agent ids, as the sweep's are
(``sweep.driver.gather_ranks``).

Not ported: the retrace guard (``ROADMAP.md`` item 12).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig, resolve_device
from dgen_tpu_torch.ensemble import stats as estats
from dgen_tpu_torch.ensemble.cohorts import (
    CohortSchedule,
    align_entry,
    cohort_alive_mask,
    potential_mask,
)
from dgen_tpu_torch.ensemble.draws import DrawSpec, draw_members
from dgen_tpu_torch.io.hostio import to_host
from dgen_tpu_torch.models.scenario import ScenarioInputs, stack_scenarios
from dgen_tpu_torch.models.simulation import SimResults, Simulation
from dgen_tpu_torch.sweep.driver import (
    agent_fields,
    bank_nbytes,
    collect_year,
    gather_ranks,
    group_step_kwargs,
    stacked_carry,
    sweep_year_step,
)
from dgen_tpu_torch.sweep.plan import MODE_LOOP, MODE_VMAP, SweepPlan, plan_sweep
from dgen_tpu_torch.sweep.results import SweepResults
from dgen_tpu_torch.utils import timing
from dgen_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: env knobs: the member count and the draw seed when the constructor
#: leaves them out
ENV_MEMBERS = "DGEN_TPU_ENSEMBLE"
ENV_SEED = "DGEN_TPU_ENSEMBLE_SEED"

#: the partial per-year statistics in the checkpoint directory
STATS_FILE = "ensemble_stats.json"

#: vmap mode's stacked-carry checkpoint subdirectory key (``scn=members/``)
_VMAP_CKPT_KEY = "members"


def ensemble_year_step(table, profiles, tariffs, inputs_e: ScenarioInputs,
                       entry_year: Optional[torch.Tensor], year_f, carry, year_idx: int,
                       **static):
    """One model year of E members: :func:`sweep_year_step` over the
    member axis of (``inputs_e``, ``carry``), ``[E, ...]`` leaves. With
    ``entry_year`` the table's mask becomes the year's alive mask
    ``mask * (entry_year <= year_f)`` first, once for every member."""
    if entry_year is not None:
        table = dataclasses.replace(table, mask=cohort_alive_mask(table.mask, entry_year,
                                                                  year_f))
    return sweep_year_step(table, profiles, tariffs, inputs_e, carry, year_idx, **static)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


class EnsembleSimulation:
    """An E-member Monte-Carlo ensemble over one shared population (the
    ensemble analogue of ``SweepSimulation``).

    ``inputs``: the base ScenarioInputs; member m perturbs it per
    ``draws`` with the key ``member_key(seed, m)``. ``n_members``:
    default the env ``DGEN_TPU_ENSEMBLE``, else 1; ``seed``: default
    ``DGEN_TPU_ENSEMBLE_SEED``, else 0. ``draws``: the default zero-width
    spec makes every member the base object. ``entry_year``: a cohort
    schedule (CohortSchedule or ``[N]`` float32 in input-table order);
    the base Simulation is built on the potential-population mask and
    the year's aliveness re-derived each year. ``quantiles``: the
    per-year quantile levels. ``max_vmap_members``: the planner's width
    cap. ``ranks``: the run's ``parallel.mesh.RankTopology``; on more
    than one rank the ensemble loops over this rank's shard (module
    docstring). Other parameters are Simulation's.
    """

    def __init__(
        self,
        table,
        profiles,
        tariffs,
        inputs: ScenarioInputs,
        scenario: ScenarioConfig,
        run_config: Optional[RunConfig] = None,
        *,
        n_members: Optional[int] = None,
        seed: Optional[int] = None,
        draws: Optional[DrawSpec] = None,
        entry_year: Union[CohortSchedule, np.ndarray, None] = None,
        with_hourly: bool = False,
        econ_years: int = 25,
        quantiles: Sequence[float] = estats.DEFAULT_QUANTILES,
        max_vmap_members: Optional[int] = None,
        plan: Optional[SweepPlan] = None,
        device="cuda",
        ranks=None,
    ) -> None:
        #: the run's rank topology when it has more than one rank, else None
        self.ranks = ranks if ranks is not None and ranks.distributed else None
        if self.ranks is not None:
            device = self.ranks.device
        self.device = resolve_device(device)
        self.n_members = int(n_members) if n_members is not None else _env_int(ENV_MEMBERS, 1)
        if self.n_members < 1:
            raise ValueError(f"n_members must be >= 1, got {self.n_members}")
        self.seed = int(seed) if seed is not None else _env_int(ENV_SEED, 0)
        self.draws = draws if draws is not None else DrawSpec()
        self.inputs = inputs
        self.scenario = scenario
        self.run_config = run_config or RunConfig()
        self.with_hourly = with_hourly
        self.quantiles = tuple(float(q) for q in quantiles)
        self.labels = [f"mem{m:03d}" for m in range(self.n_members)]

        if isinstance(entry_year, CohortSchedule):
            entry_input = entry_year.entry_year
        elif entry_year is not None:
            entry_input = np.asarray(entry_year, np.float32)
        else:
            entry_input = None
        if entry_input is not None:
            if len(entry_input) != table.n_agents:
                raise ValueError(f"entry_year covers {len(entry_input)} rows but the "
                                 f"table has {table.n_agents}")
            # placement sees the potential population: every row that
            # will ever be alive takes part in the static flags, the
            # clustering and the padding
            pot = potential_mask(table.mask.cpu().numpy(), entry_input)
            table = dataclasses.replace(table, mask=torch.from_numpy(pot).to(table.mask.device))
        self._entry_input = entry_input

        #: member m's ScenarioInputs, a function of (base, seed, m) only;
        #: with a zero-width DrawSpec every element is the base object
        self.members: List[ScenarioInputs] = draw_members(inputs, self.draws,
                                                          self.n_members, self.seed)
        rc = self.run_config
        self.plan = plan if plan is not None else plan_sweep(
            [inputs], list(scenario.model_years), table=table, tariffs=tariffs,
            with_hourly=with_hourly, econ_years=econ_years,
            sizing_iters=rc.sizing_iters, bank_bf16=rc.bf16_banks,
            bank_quant=rc.quant_banks, max_vmap_scenarios=max_vmap_members,
            cluster=rc.cluster_tariffs, agent_pad_multiple=rc.agent_pad_multiple,
            n_members=self.n_members, device=self.device, mesh=self.ranks,
        )
        if self.plan.agent_chunk is not None and rc.agent_chunk is None:
            rc = dataclasses.replace(rc, agent_chunk=self.plan.agent_chunk)
        self.base = Simulation(table, profiles, tariffs, inputs, scenario, rc,
                               with_hourly=with_hourly, econ_years=econ_years,
                               device=self.device, ranks=self.ranks)
        self.years = self.base.years
        self.bank_bytes_shared = bank_nbytes(self.base.profiles)
        group = self.plan.groups[0]
        self.net_billing = group.net_billing
        # E = 1 steps the base Simulation's own year step with its own
        # operands: equal to Simulation.run bit for bit
        self.mode = MODE_LOOP if self.n_members == 1 else group.mode

        # cohort operands on the card, in the placed row order
        if entry_input is not None:
            aligned = align_entry(entry_input, self.base.host_row_origin)
            self._entry_dev = torch.from_numpy(aligned).to(self.device)
            self._mask_pot_dev = self.base.table.mask
        else:
            self._entry_dev = None
            self._mask_pot_dev = None
        logger.info(
            "ensemble: E=%d seed=%d draws=%s cohorts=%s -> %s mode (net_billing=%s, "
            "agent_chunk=%s)", self.n_members, self.seed,
            "zero" if self.draws.is_zero else "on",
            "none" if entry_input is None else
            f"{int(np.sum((entry_input > 0) & (entry_input < 1e9)))} rows",
            self.mode, self.net_billing, self.plan.agent_chunk)

    # -- stats sidecar --------------------------------------------------

    def _stats_path(self, checkpoint_dir: str) -> str:
        return os.path.join(checkpoint_dir, STATS_FILE)

    def _load_stats_state(self, checkpoint_dir: Optional[str], mode: str) -> Optional[dict]:
        if not checkpoint_dir:
            return None
        path = self._stats_path(checkpoint_dir)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if (state.get("mode") != mode
                or int(state.get("n_members", -1)) != self.n_members
                or list(state.get("quantiles", [])) != list(self.quantiles)):
            logger.warning("ensemble stats sidecar %s does not match this run "
                           "(mode/members/quantiles); ignoring it", path)
            return None
        return state

    def _alive(self, year) -> torch.Tensor:
        """The year's alive mask (the placed mask without cohorts)."""
        if self._entry_dev is None:
            return self.base.table.mask
        return cohort_alive_mask(self._mask_pot_dev, self._entry_dev, float(year))

    # -- loop mode ------------------------------------------------------

    def _run_loop(self, collect: bool, checkpoint_dir: Optional[str], resume: bool):
        from dgen_tpu_torch.io import checkpoint as ckpt

        E = self.n_members
        years = self.years
        n_states = self.base.table.n_states
        state_idx = self.base.table.state_idx
        fields = agent_fields()
        nat_curves = {m: np.full((E, len(years)), np.nan, np.float64)
                      for m in estats.METRIC_FIELDS}
        st_curves = {m: np.full((E, len(years), n_states), np.nan, np.float64)
                     for m in estats.STATE_METRICS}
        if resume:
            state = self._load_stats_state(checkpoint_dir, "loop")
            if state is not None:
                for m, v in state.get("national", {}).items():
                    nat_curves[m][:] = np.asarray(v, np.float64)
                for m, v in state.get("state", {}).items():
                    st_curves[m][:] = np.asarray(v, np.float64)

        def persist() -> None:
            # the sums are every rank's: rank 0 writes them
            if not checkpoint_dir or (self.ranks is not None and self.ranks.rank):
                return
            atomic_write_json(self._stats_path(checkpoint_dir), {
                "mode": "loop", "n_members": E, "quantiles": list(self.quantiles),
                "national": {m: v.tolist() for m, v in nat_curves.items()},
                "state": {m: v.tolist() for m, v in st_curves.items()},
            })

        results: List[SimResults] = []
        for mi in range(E):
            member = self.members[mi]
            if member is self.inputs and self._entry_dev is None:
                # zero-width draws, no cohorts: the member is the base
                sib = self.base
            else:
                sib = self.base.with_inputs(member, net_billing=self.net_billing,
                                            timing_ctx=self.labels[mi])
            mdir = ckpt.member_dir(checkpoint_dir, mi) if checkpoint_dir else None
            start_idx = 0
            carry = sib.init_carry()
            if resume and mdir:
                last = ckpt.latest_year(mdir)
                if self.ranks is not None:
                    # every rank resumes at rank 0's year
                    last = int(self.ranks.broadcast(torch.tensor(
                        [-1 if last is None else last], dtype=torch.int64))[0])
                    last = None if last < 0 else last
                if last is not None and last not in years:
                    raise ValueError(f"checkpointed year {last} of member {mi} is not on "
                                     f"the year grid {years}; refusing to resume")
                if last is not None:
                    carry = sib._restore_carry(mdir, last)
                    start_idx = years.index(last) + 1
                    logger.info("ensemble member %d: resuming after year %d", mi, last)
            writer = sib.checkpoint_writer(mdir) if mdir else None
            collected: Dict[str, list] = {k: [] for k in fields}
            hourly: List[np.ndarray] = []
            try:
                for yi, year in enumerate(years):
                    if yi < start_idx:
                        continue
                    alive = self._alive(year)
                    if self._entry_dev is not None:
                        sib.table = dataclasses.replace(sib.table, mask=alive)
                    with timing.timer("ensemble_year_step", ctx=self.labels[mi]):
                        carry, outs = sib.step(carry, yi, first_year=(yi == 0))
                    nat, st = estats.member_aggregates(outs, alive, state_idx,
                                                       n_states=n_states)
                    if self.ranks is not None:
                        # this rank's partial sums, summed over the ranks
                        nat = {k: self.ranks.all_reduce(v) for k, v in nat.items()}
                        st = {k: self.ranks.all_reduce(v) for k, v in st.items()}
                    # a scalar block a (member, year): O(quantiles) traffic
                    host = to_host({"nat": nat, "st": st})
                    for k, v in host["nat"].items():
                        nat_curves[k][mi, yi] = float(v)
                    for k, v in host["st"].items():
                        st_curves[k][mi, yi] = np.asarray(v)
                    if collect:
                        collect_year(outs, collected, hourly if self.with_hourly else None)
                    if writer is not None:
                        writer.save(year, carry)
                        persist()
            finally:
                if writer is not None:
                    writer.close()
            run_years = years[start_idx:]
            agent = ({k: np.stack(v) for k, v in collected.items()}
                     if collect and collected[fields[0]] else {})
            results.append(SimResults(years=list(run_years), agent=agent,
                                      state_hourly_net_mw=np.stack(hourly) if hourly else None))
        persist()
        if any(np.isnan(v).any() for v in nat_curves.values()):
            logger.warning("ensemble stats are incomplete (resumed without a stats "
                           "sidecar?): the quantiles carry NaNs")
        stats = estats.stats_from_member_aggregates(years, self.quantiles, nat_curves,
                                                    st_curves)
        return results, stats

    # -- vmap mode ------------------------------------------------------

    def stacked_inputs(self) -> ScenarioInputs:
        """The members' inputs stacked, ``[E, ...]`` leaves on the card."""
        from dgen_tpu_torch.tree import to_device

        return stack_scenarios([to_device(m, self.device) for m in self.members]).inputs

    def _run_vmap(self, collect: bool, checkpoint_dir: Optional[str], resume: bool):
        from dgen_tpu_torch.io import checkpoint as ckpt

        E = self.n_members
        years = self.years
        base = self.base
        n_states = base.table.n_states
        state_idx = base.table.state_idx
        inputs_e = self.stacked_inputs()
        kwargs = group_step_kwargs(base, self.net_billing, first_year=True)
        rows = base.checkpoint_rows
        carry = stacked_carry(base, E)
        start_idx = 0
        if resume:
            if not checkpoint_dir:
                raise ValueError("resume=True requires checkpoint_dir")
            last = ckpt.latest_year(checkpoint_dir, scenario=_VMAP_CKPT_KEY)
            if last is not None and last not in years:
                raise ValueError(f"checkpointed year {last} is not on the year grid "
                                 f"{years}; refusing to resume")
            if last is not None:
                _, carry = ckpt.restore_year(checkpoint_dir, base.table.n_agents, last,
                                             device=self.device, rows=rows,
                                             scenario=_VMAP_CKPT_KEY, n_scenarios=E)
                start_idx = years.index(last) + 1
                logger.info("ensemble (vmap): resuming after year %d", last)
        writer = (ckpt.Writer(checkpoint_dir, rows=rows, scenario=_VMAP_CKPT_KEY)
                  if checkpoint_dir is not None else None)

        blocks: Dict[int, dict] = {}
        if resume:
            state = self._load_stats_state(checkpoint_dir, "vmap")
            if state is not None:
                blocks = {
                    int(k): {part: {m: np.asarray(a, np.float32)
                                    for m, a in v[part].items()}
                             for part in ("national", "state")}
                    for k, v in state.get("blocks", {}).items()
                }

        def persist() -> None:
            if not checkpoint_dir:
                return
            atomic_write_json(self._stats_path(checkpoint_dir), {
                "mode": "vmap", "n_members": E, "quantiles": list(self.quantiles),
                "blocks": {str(k): {part: {m: np.asarray(a).tolist()
                                           for m, a in v[part].items()}
                                    for part in ("national", "state")}
                           for k, v in blocks.items()},
            })

        qs_dev = torch.tensor(self.quantiles, dtype=torch.float32, device=self.device)
        fields = agent_fields()
        collected: Dict[str, list] = {k: [] for k in fields}
        hourly: List[np.ndarray] = []
        try:
            for yi, year in enumerate(years):
                if yi < start_idx:
                    continue
                kwargs["first_year"] = yi == 0
                year_f = float(year) if self._entry_dev is not None else None
                with timing.timer("ensemble_year_step", ctx="vmap"):
                    carry, outs = ensemble_year_step(
                        base.table, base.profiles, base.tariffs, inputs_e,
                        self._entry_dev, year_f, carry, yi, **kwargs)
                nat, st = estats.member_aggregates(outs, self._alive(year), state_idx,
                                                   n_states=n_states)
                # the year's whole host fetch: [Q] and [Q, n_states] blocks
                blocks[yi] = to_host({"national": estats.year_quantiles(nat, qs_dev),
                                      "state": estats.year_quantiles(st, qs_dev)})
                if collect:
                    collect_year(outs, collected, hourly if self.with_hourly else None)
                if writer is not None:
                    writer.save(year, carry)
                    persist()
                del outs
        finally:
            if writer is not None:
                writer.close()
        persist()

        run_years = years[start_idx:]
        results: List[SimResults] = []
        for m in range(E):
            agent = ({k: np.stack([v[m] for v in vs]) for k, vs in collected.items()}
                     if collect and collected[fields[0]] else {})
            results.append(SimResults(
                years=list(run_years), agent=agent,
                state_hourly_net_mw=np.stack([h[m] for h in hourly]) if hourly else None))
        stats = estats.stats_from_year_blocks(years, self.quantiles, E, blocks)
        return results, stats

    # -- the ensemble ---------------------------------------------------

    def run(self, collect: bool = False, checkpoint_dir: Optional[str] = None,
            resume: bool = False) -> SweepResults:
        """Every member over every model year; returns :class:`SweepResults`
        whose ``quantiles`` is the per-year :class:`~dgen_tpu_torch.
        ensemble.stats.EnsembleStats`. ``collect`` (off by default: the
        answer is the bands) keeps every member's per-agent outputs.
        ``checkpoint_dir``: (member, year)-grained resume, with the stats
        sidecar."""
        if self.mode == MODE_VMAP:
            results, stats = self._run_vmap(collect, checkpoint_dir, resume)
        else:
            results, stats = self._run_loop(collect, checkpoint_dir, resume)
        rep_q = self.base.quarantine_report
        mask, ids = self.base.host_mask, self.base.host_agent_id
        if self.ranks is not None:
            results, mask, ids = gather_ranks(self.ranks, results, mask, ids)
        return SweepResults(
            labels=list(self.labels),
            baseline=0,
            runs=results,
            plan=self.plan,
            bank_bytes_shared=self.bank_bytes_shared,
            host_mask=mask,
            host_agent_id=ids,
            quarantine=(rep_q.summary()
                        if rep_q is not None and not rep_q.is_clean else None),
            quantiles=stats,
        )
