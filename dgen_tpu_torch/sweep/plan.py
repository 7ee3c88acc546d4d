"""Sweep planner (port of ``dgen_tpu/sweep/plan.py``): group scenarios
so each group shares one set of static year-step arguments, and budget
the batched scenario axis against the port's device-memory model.

Scenarios of a sweep run against one table and one copy of the profile
banks on the card; only the small ``[Y, ...]`` trajectory tensors of
:class:`~dgen_tpu_torch.models.scenario.ScenarioInputs` vary. Two
things still split the run:

* a static-shape mismatch (a different year grid, or group, region or
  state axis) is refused with an error naming the field
  (:func:`~dgen_tpu_torch.models.scenario.validate_scenario_statics`);
* the net-billing flag (:func:`~dgen_tpu_torch.models.simulation.
  run_static_flags`): an all-NEM scenario skips the bucket-sums kernel.
  Scenarios are grouped by it, in first-seen order, so group 0 holds
  scenario 0, the conventional baseline.

Per group the planner picks the mode: ``vmap`` sizes the group's S
scenarios together (S x chunk rows a kernel launch,
:func:`~dgen_tpu_torch.sweep.driver.sweep_year_step`), ``loop`` runs
them one after another over the single-scenario year step when S would
not fit. The budget is the port's own byte model, not the JAX
package's: :func:`~dgen_tpu_torch.models.simulation.per_agent_step_bytes`
(the port's live ``[8760]``-hour and bucket tensors a row, which count
``12 * n_periods`` buckets where the JAX package pads to ``B_PAD``),
``_PERSISTENT_ROW_BYTES`` (60 x 4 bytes a row in the port against the
JAX package's 50 x 4), ``_MEMORY_BUDGET_FRAC`` of the card's memory
(:func:`~dgen_tpu_torch.models.simulation.card_memory_bytes`) and the
``_CHUNK_FLOOR_ROWS`` streaming floor. The persistent ``[S, N]`` carry
is counted S-wide (S x E with ensemble members). A plan that cannot fit
even a floor-sized chunk raises :class:`SweepBudgetError`.

On several ranks (``mesh``: the run's ``parallel.mesh.RankTopology``,
the port's mesh) every group runs the scenario-major loop over each
rank's shard, as the JAX package's planner loops on a mesh of more than
one device: the single-scenario multi-rank year step as it is, its chunk
budgeted against this rank's share of its card
(``models.simulation.rank_memory_bytes``) and its shard's rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgen_tpu_torch.models.scenario import ScenarioInputs, validate_scenario_statics
from dgen_tpu_torch.models.simulation import (
    _CHUNK_FLOOR_ROWS,
    _MEMORY_BUDGET_FRAC,
    _PERSISTENT_ROW_BYTES,
    auto_agent_chunk,
    per_agent_step_bytes,
    rank_memory_bytes,
    run_static_flags,
    table_static_cache,
)

#: vmap-width cap when the device exposes no memory budget (the CPU):
#: small sweeps batch, large ones run the scenario-major loop
DEFAULT_MAX_VMAP_SCENARIOS = 8

MODE_VMAP = "vmap"
MODE_LOOP = "loop"


class SweepBudgetError(ValueError):
    """A sweep plan that cannot fit the card's memory even at the
    streaming-chunk floor. The message names the budget, the footprint
    that broke it and the byte model behind it."""


def _gib(n: int) -> str:
    return f"{n / 1024**3:.2f} GiB"


def _budget_error(*, what: str, need_bytes: int, hbm_bytes: int, n_rows: int,
                  group_scenarios: int, per_agent: int) -> SweepBudgetError:
    return SweepBudgetError(
        f"sweep plan over budget: {what} needs {_gib(need_bytes)}, but the "
        f"card budgets {_gib(int(hbm_bytes * _MEMORY_BUDGET_FRAC))} "
        f"({_MEMORY_BUDGET_FRAC:.0%} of {_gib(hbm_bytes)}) for {n_rows} agent "
        f"rows at {per_agent} modeled bytes/row "
        f"(models.simulation.per_agent_step_bytes); the scenario-major loop "
        f"holds ONE of the group's {group_scenarios} scenario(s) resident at "
        f"a time, so this is already the plan's cheapest mode. Fixes: split "
        f"the scenario axis across runs, or shrink the table."
    )


@dataclasses.dataclass(frozen=True)
class ScenarioGroup:
    """Scenarios that share one set of static year-step arguments."""

    indices: Tuple[int, ...]     # positions in the sweep's scenario list
    net_billing: bool            # the group's bill flag
    mode: str                    # MODE_VMAP | MODE_LOOP

    @property
    def n_scenarios(self) -> int:
        return len(self.indices)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Execution plan of an S-scenario sweep."""

    groups: Tuple[ScenarioGroup, ...]
    n_scenarios: int
    #: streaming chunk the sweep runs with (``RunConfig.agent_chunk``):
    #: None = keep the operator's setting (no memory information);
    #: 0 = whole table; > 0 = budgeted for the widest vmap group
    agent_chunk: Optional[int]
    #: the card's bytes the budget used (None = unknown, the CPU)
    hbm_bytes: Optional[int]
    #: modeled peak step bytes per (agent x scenario) row
    per_agent_bytes: int
    #: (hosts, devices) of the ranks: (1, 1) for one process
    mesh_shape: Tuple[int, int] = (1, 1)
    #: hbm_bytes over every rank (the same as hbm_bytes for one process)
    global_hbm_bytes: Optional[int] = None
    #: ensemble members riding each scenario: every width decision was
    #: made at ``S * n_members`` rows
    n_members: int = 1

    @property
    def max_vmap_width(self) -> int:
        widths = [g.n_scenarios for g in self.groups if g.mode == MODE_VMAP]
        return max(widths) if widths else 1


def plan_sweep(
    scenarios: Sequence[ScenarioInputs],
    years: List[int],
    *,
    table,
    tariffs,
    with_hourly: bool = False,
    econ_years: int = 25,
    sizing_iters: int = 12,
    bank_bf16: bool = False,
    bank_quant: bool = False,
    mesh=None,
    hbm_bytes: Optional[int] = -1,
    max_vmap_scenarios: Optional[int] = None,
    enforce_budget: bool = True,
    cluster: bool = False,
    agent_pad_multiple: int = 128,
    n_members: int = 1,
    device=None,
) -> SweepPlan:
    """Plan an S-scenario sweep over one shared population.

    ``hbm_bytes``: the card's memory a process (a rank) plans for; ``-1``
    reads ``device`` (default: the table's device, or the ranks') through
    ``rank_memory_bytes``, this rank's share of its card, None off a card;
    None means unknown, and the modes then follow the width cap
    :data:`DEFAULT_MAX_VMAP_SCENARIOS` (``max_vmap_scenarios`` overrides
    it). ``mesh``: the ranks' ``parallel.mesh.RankTopology``; on more
    than one rank every group loops over the rank's shard of the table. ``cluster``: budget a tariff-clustered layout, whose
    segments add up to one ``agent_pad_multiple`` of rows a live
    cluster. ``n_members``: ensemble members a scenario; every width
    decision is made at ``S * n_members`` rows. ``enforce_budget=False``
    returns the best-effort plan where the floor chunk does not fit.

    Raises :class:`~dgen_tpu_torch.models.scenario.ScenarioStackError`
    when scenarios disagree on a static field, :class:`SweepBudgetError`
    when not even the floor chunk fits, and ``TypeError`` for a mesh that
    is no ``RankTopology``."""
    from dgen_tpu_torch.parallel.mesh import RankTopology

    if mesh is not None and not isinstance(mesh, RankTopology):
        raise TypeError(f"mesh must be a parallel.mesh.RankTopology, not "
                        f"{type(mesh).__name__}")
    ranked = mesh is not None and mesh.distributed
    scenarios = list(scenarios)
    validate_scenario_statics(scenarios)
    n_members = max(int(n_members), 1)
    if hbm_bytes == -1:
        dev = (mesh.device if mesh is not None else
               device if device is not None else table.mask.device)
        hbm_bytes = rank_memory_bytes(torch.device(dev), mesh)
    max_vmap = (max_vmap_scenarios if max_vmap_scenarios is not None
                else DEFAULT_MAX_VMAP_SCENARIOS)

    tcache = table_static_cache(table, tariffs)
    rate_switch = tcache["rate_switch"]
    by_flag: dict = {}
    for i, inputs in enumerate(scenarios):
        _, nb = run_static_flags(table, tariffs, inputs, years, table_cache=tcache)
        by_flag.setdefault(nb, []).append(i)

    n_rows = table.n_agents
    world = mesh.world_size if ranked else 1
    if cluster and not rate_switch:
        from dgen_tpu_torch.ops.tariffcluster import analyze_bank

        plan_c = analyze_bank(tariffs)
        tidx = table.tariff_idx.cpu().numpy()
        live = np.unique(plan_c.cluster_of_tariff[tidx[table.mask.cpu().numpy() > 0]])
        n_rows += len(live) * int(agent_pad_multiple) * world
    # a rank's shard of the rows
    n_rows = -(-n_rows // world)

    footprint = dict(sizing_iters=sizing_iters, econ_years=econ_years,
                     n_periods=tariffs.max_periods, with_hourly=with_hourly,
                     rate_switch=rate_switch, bank_bf16=bank_bf16, bank_quant=bank_quant)
    # the port's per-row model does not depend on the bill flag
    per_agent = per_agent_step_bytes(**footprint)

    def check_chunk_floor(group_scenarios: int) -> None:
        # even a floor-sized chunk beside the persistent rows (loop mode
        # keeps one scenario resident) busts the budget: auto_agent_chunk
        # would return the floor and the run would run out of memory
        if hbm_bytes is None or not enforce_budget:
            return
        budget = int(hbm_bytes * _MEMORY_BUDGET_FRAC)
        persistent = n_rows * _PERSISTENT_ROW_BYTES
        need_rows = min(n_rows, _CHUNK_FLOOR_ROWS)
        if (budget - persistent) // per_agent < need_rows:
            raise _budget_error(
                what=f"the scenario-major loop's floor chunk ({_CHUNK_FLOOR_ROWS} rows)",
                need_bytes=persistent + need_rows * per_agent, hbm_bytes=hbm_bytes,
                n_rows=n_rows, group_scenarios=group_scenarios, per_agent=per_agent)

    groups: List[ScenarioGroup] = []
    chunk: Optional[int] = None
    for nb, idxs in by_flag.items():
        s = len(idxs)
        w = s * n_members
        if ranked:
            # several ranks: the scenario-major loop over each rank's shard,
            # the single-scenario multi-rank year step as it is
            mode = MODE_LOOP
            if hbm_bytes is not None:
                check_chunk_floor(s)
                c = auto_agent_chunk(n_rows, memory_bytes=hbm_bytes, **footprint)
                if c:
                    chunk = c if chunk is None else min(chunk, c)
        elif hbm_bytes is None:
            mode = MODE_VMAP if w <= max_vmap else MODE_LOOP
        else:
            # (S x E) x N rows against the card, the persistent [S*E, N]
            # carry counted (S*E)-wide
            budget = int(hbm_bytes * _MEMORY_BUDGET_FRAC) - w * n_rows * _PERSISTENT_ROW_BYTES
            rows_fit = max(budget, 0) // per_agent
            if w <= max_vmap and w * n_rows <= rows_fit:
                mode = MODE_VMAP                # whole table, (S*E) wide
            elif w <= max_vmap and rows_fit // w >= _CHUNK_FLOOR_ROWS:
                mode = MODE_VMAP                # chunked, (S*E) wide
                c = int(rows_fit // w) // _CHUNK_FLOOR_ROWS * _CHUNK_FLOOR_ROWS
                chunk = c if chunk is None else min(chunk, c)
            else:
                mode = MODE_LOOP
                check_chunk_floor(s)
                c = auto_agent_chunk(n_rows, memory_bytes=hbm_bytes, **footprint)
                if c:
                    chunk = c if chunk is None else min(chunk, c)
        groups.append(ScenarioGroup(indices=tuple(idxs), net_billing=nb, mode=mode))

    if hbm_bytes is not None and chunk is None:
        chunk = 0   # everything fits whole

    return SweepPlan(
        groups=tuple(groups),
        n_scenarios=len(scenarios),
        agent_chunk=chunk,
        hbm_bytes=hbm_bytes,
        per_agent_bytes=per_agent,
        mesh_shape=mesh.shape if mesh is not None else (1, 1),
        global_hbm_bytes=hbm_bytes * world if hbm_bytes is not None else None,
        n_members=n_members,
    )
