"""The serving engine: per-agent what-if queries against the placed agent
table and banks (port of ``dgen_tpu/serve/engine.py``).

A live product asks pointwise questions: *what is this customer's
optimal PV+storage size, bill savings and payback under this tariff or
incentive tweak?* That is one row of the model year's sizing path (the
bill engine, the sizing search and the cash flow), answered for the rows
a request names.

Design contract:

* the agent table, the profile banks and the tariff bank are placed once,
  by the :class:`~dgen_tpu_torch.models.simulation.Simulation` the engine
  wraps, and never uploaded again per query;
* a query bucket runs at a fixed row count (a power of two of
  ``ServeConfig.buckets``, the first requested row repeated as padding),
  and every bucket is run once at warmup, so the kernel library is built
  and loaded before the first request (``ops._build.EVENTS`` stays put
  after warmup);
* a what-if override changes data, never code: it rebuilds the touched
  ``[Y, ...]`` ScenarioInputs leaves in numpy at their dtype and shape and
  moves only those to the device.

An answer is a pure function of (banks, inputs, rows, year): the bucket
is evaluated at first-year market state (:func:`starting_state_kw`), the
one cross-agent term, the NEM state cap, depends on the inputs alone, and
every kernel reduces each row on its own. A bucket launches at least
:data:`LAUNCH_ROW_FLOOR` rows, so an agent's answer is the same bits
whether it was computed alone, padded, or coalesced with other requests.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dgen_tpu_torch.models.scenario import ScenarioInputs, apply_year
from dgen_tpu_torch.models.simulation import (
    Simulation,
    build_econ_inputs,
    compute_nem_allowed,
    starting_state_kw,
)
from dgen_tpu_torch.ops import sizing as sizing_ops
from dgen_tpu_torch.resilience.faults import fault_point
from dgen_tpu_torch.resilience.quarantine import QuarantinedAgentError
from dgen_tpu_torch.tree import tree_map

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class QueryOutputs:
    """Per-agent answers of one query bucket (every leaf ``[B, ...]``):
    the sizing and economics columns a full run writes per agent a year."""

    agent_id: torch.Tensor                    # [B] int32
    nem_allowed: torch.Tensor                 # [B] 1.0 = NEM available
    system_kw: torch.Tensor
    npv: torch.Tensor
    payback_period: torch.Tensor
    batt_kw: torch.Tensor
    batt_kwh: torch.Tensor
    first_year_bill_with_system: torch.Tensor
    first_year_bill_without_system: torch.Tensor
    bill_savings_y1: torch.Tensor             # without - with, year 1
    annual_kwh: torch.Tensor
    capacity_factor: torch.Tensor
    cash_flow: torch.Tensor                   # [B, Y+1]


#: QueryOutputs field names in declaration order (the JSON row schema)
QUERY_FIELDS = tuple(f.name for f in dataclasses.fields(QueryOutputs))

#: the fewest rows a bucket launches (the first requested row repeats up
#: to it). Below 16 rows PyTorch's CUDA reductions pick another reduction
#: tree for the same row: a row sum over more than 32 lanes (the month
#: sums of ``ops/bill.py``, the annual generation of ``ops/sizing.py``)
#: runs min(rows, 16) rows a block of 512 threads, so its lanes split
#: over 512 / min(rows, 16) threads. From 16 rows on the tree is fixed and
#: a row's sums do not depend on how many rows share the launch
#: (``tools/row_count_probe.py`` finds the first operation that does).
LAUNCH_ROW_FLOOR = 16


def query_static_kwargs(sim: Simulation) -> dict:
    """The static arguments of :func:`query_program` for a built
    Simulation. ``net_billing`` is pinned True: an override can close a
    NEM gate the base scenario holds open, and True is exact either way
    (False only skips the bucket-sums kernels)."""
    return dict(
        n_periods=sim.tariffs.max_periods,
        econ_years=sim.econ_years,
        sizing_iters=sim.run_config.sizing_iters,
        sizing_impl="auto",
        rate_switch=sim._rate_switch,
        net_billing=True,
        daylight=sim._daylight,
    )


def query_program(
    table,
    profiles,
    tariffs,
    inputs: ScenarioInputs,
    idx: torch.Tensor,
    year_idx: int,
    *,
    n_periods: int,
    econ_years: int,
    sizing_iters: int,
    sizing_impl: str = "auto",
    rate_switch: bool = False,
    net_billing: bool = True,
    daylight=None,
    cluster_tidx: Optional[torch.Tensor] = None,
) -> QueryOutputs:
    """One query bucket: gather the B rows ``idx`` ([B] int64 on the
    table's device) from the placed table, rebuild their one-year
    economics and size them through the year step's
    :func:`~dgen_tpu_torch.ops.sizing.size_agents`.

    The bucket is evaluated at first-year market state (the scenario's
    starting state capacities): the answer to "this customer, deciding in
    model year ``year_idx``", independent of any run's carry.

    ``cluster_tidx``: a clustered Simulation's per-row compact tariff
    indices, passed with one cluster's compact bank as ``tariffs`` and
    the cluster's ``n_periods`` (a mono-cluster bucket); None prices
    against the full bank.
    """
    sub = tree_map(lambda a: a[idx], table)
    if cluster_tidx is not None:
        tidx = cluster_tidx[idx]
        sub = dataclasses.replace(sub, tariff_idx=tidx, tariff_switch_idx=tidx)
    ya = apply_year(sub, inputs, year_idx)
    state_kw = starting_state_kw(table, inputs)
    nem_allowed = compute_nem_allowed(sub, inputs, year_idx, state_kw)
    envs = build_econ_inputs(sub, profiles, tariffs, ya, nem_allowed, sub.incentives,
                             rate_switch=rate_switch)
    res = sizing_ops.size_agents(
        envs, n_periods=n_periods, n_years=econ_years, n_iters=sizing_iters,
        keep_hourly=False, impl=sizing_impl, net_billing=net_billing,
        daylight=daylight,
    )
    return QueryOutputs(
        agent_id=sub.agent_id,
        nem_allowed=nem_allowed,
        system_kw=res.system_kw,
        npv=res.npv,
        payback_period=res.payback_period,
        batt_kw=res.batt_kw,
        batt_kwh=res.batt_kwh,
        first_year_bill_with_system=res.first_year_bill_with_system,
        first_year_bill_without_system=res.first_year_bill_without_system,
        bill_savings_y1=(res.first_year_bill_without_system
                         - res.first_year_bill_with_system),
        annual_kwh=res.annual_energy_production_kwh,
        capacity_factor=res.capacity_factor,
        cash_flow=res.cash_flow,
    )


def launch_rows(rows: np.ndarray, shape: int) -> np.ndarray:
    """The rows a bucket of ``shape`` rows launches: ``rows`` followed by
    its first row repeated up to ``max(shape, LAUNCH_ROW_FLOOR)``."""
    width = max(int(shape), LAUNCH_ROW_FLOOR)
    fill = rows[0] if rows.size else 0
    return np.concatenate([rows, np.full(width - rows.shape[0], fill, dtype=np.int32)])


class OverrideError(ValueError):
    """A scenario override names an unknown field or does not fit the
    field's shape or dtype."""


def apply_overrides(inputs: ScenarioInputs, overrides: Optional[dict]) -> ScenarioInputs:
    """A what-if variant of ``inputs``: ``{"set": {field: v}, "scale":
    {field: f}}`` replaces or scales named trajectory fields.

    Values broadcast to the field's shape and keep its dtype; an integer
    field refuses a value (or a scaled result) that is not an integer.
    The arithmetic runs in numpy; only the touched leaves are moved to
    the device, and every other leaf is the base's placed tensor."""
    if not overrides:
        return inputs
    valid = {f.name for f in dataclasses.fields(ScenarioInputs)}
    unknown_ops = set(overrides) - {"set", "scale"}
    if unknown_ops:
        raise OverrideError(
            f"unknown override op(s) {sorted(unknown_ops)}; expected "
            "{'set': {field: value}, 'scale': {field: factor}}")
    host_new: Dict[str, np.ndarray] = {}
    for op in ("set", "scale"):
        for field, value in (overrides.get(op) or {}).items():
            if field not in valid:
                raise OverrideError(
                    f"unknown ScenarioInputs field '{field}'; valid fields: "
                    f"{', '.join(sorted(valid))}")
            host = host_new.get(field)
            if host is None:
                host = getattr(inputs, field).cpu().numpy()
            is_int = np.issubdtype(host.dtype, np.integer)
            try:
                if op == "set":
                    v = np.asarray(value, dtype=host.dtype)
                    if is_int and not np.array_equal(v, np.asarray(value)):
                        raise ValueError("lossy integer conversion")
                    new = np.broadcast_to(v, host.shape)
                else:
                    # scaled in float64, so an integer field that lands off
                    # its grid raises instead of truncating
                    exact = host * np.asarray(value, dtype=np.float64)
                    new = exact.astype(host.dtype)
                    if is_int and not np.array_equal(new, exact):
                        raise ValueError("lossy integer conversion")
                if new.shape != host.shape:
                    raise ValueError("shape changed")
            except (TypeError, ValueError) as e:
                raise OverrideError(
                    f"override for '{field}' does not fit its static shape/dtype "
                    f"({host.shape}, {host.dtype}): {e}") from e
            host_new[field] = np.ascontiguousarray(new)
    repl = {f: torch.from_numpy(a.copy()).to(getattr(inputs, f).device)
            for f, a in host_new.items()}
    return dataclasses.replace(inputs, **repl)


def override_key(overrides: Optional[dict]) -> str:
    """Canonical string of an override dict (the microbatcher coalesces
    requests that share it)."""
    if not overrides:
        return ""
    return json.dumps(overrides, sort_keys=True, default=float)


class ServeEngine:
    """Long-lived query engine over one placed population.

    ``sim``: a built :class:`~dgen_tpu_torch.models.simulation.Simulation`
    on its device; the engine reuses its placed table and banks, its
    static flags (rate switch, daylight layout, tariff clusters) and its
    year grid. ``max_override_cache``: LRU size of resolved override
    variants.
    """

    def __init__(self, sim: Simulation, max_override_cache: int = 128) -> None:
        self.sim = sim
        self.device = sim.device
        self.years = list(sim.years)
        self._year_to_idx = {int(y): i for i, y in enumerate(self.years)}
        # stable id -> table row; padding rows (mask 0) reuse id fill
        # values, so only masked-in rows claim an id
        mask = np.asarray(sim.host_mask) > 0
        ids = np.asarray(sim.host_agent_id)
        self._id_to_row: Dict[int, int] = {}
        for row in np.flatnonzero(mask):
            self._id_to_row.setdefault(int(ids[row]), int(row))
        self.n_agents = int(mask.sum())
        # quarantined agents: their rows exist but were contained at load;
        # a query for one raises QuarantinedAgentError (HTTP 422)
        rep = sim.quarantine_report
        self._quarantined: Dict[int, list] = (
            {int(a): rep.reasons_for(a) for a in rep.ids} if rep is not None else {})
        self._static_kwargs = query_static_kwargs(sim)
        # a clustered Simulation: a mono-cluster bucket runs against its
        # cluster's compact bank at the cluster's period count; a mixed
        # bucket against the full bank
        layout = sim._cluster_layout
        self._cluster = None
        if layout is not None:
            self._cluster = dict(
                cid=layout.cluster_of_rows(),
                banks=sim._cluster_banks,
                tidx=sim._cluster_tidx,
                statics=tuple(dict(self._static_kwargs, n_periods=c.n_periods,
                                   rate_switch=False)
                              for c in layout.clusters),
            )
        self._override_cache: "OrderedDict[str, ScenarioInputs]" = OrderedDict()
        self._lock = threading.Lock()
        self._max_override_cache = int(max_override_cache)
        # the engine-free layers, attached at boot
        self._surface = None
        self._result_cache = None
        #: why a configured surface was refused, for /metricz
        self.surface_refused: Optional[str] = None
        # row counts run at least once (the /healthz "warm" report)
        self._warm: set = set()

    # -- engine-free layers --------------------------------------------

    @property
    def surface(self):
        """The attached :class:`~dgen_tpu_torch.serve.surface.AnswerSurface`
        (or None): zero-override queries for covered years answer from
        its map."""
        return self._surface

    @property
    def result_cache(self):
        """The attached :class:`~dgen_tpu_torch.serve.resultcache.ResultCache`
        (or None)."""
        return self._result_cache

    def attach_surface(self, surface) -> None:
        self._surface = surface

    def attach_result_cache(self, cache) -> None:
        self._result_cache = cache

    def serve_stats(self) -> dict:
        """Surface and cache counters for /metricz."""
        rec = {}
        if self._surface is not None:
            rec["surface"] = self._surface.stats()
        elif self.surface_refused:
            rec["surface_refused"] = self.surface_refused
        if self._result_cache is not None:
            rec["result_cache"] = self._result_cache.stats()
        return rec

    @property
    def warm_buckets(self) -> tuple:
        """Sorted row counts run so far (a snapshot taken under the lock)."""
        with self._lock:
            return tuple(sorted(self._warm))

    # -- request plumbing ----------------------------------------------

    def rows_for(self, agent_ids: Sequence[int]) -> np.ndarray:
        """[n] int32 table rows of stable agent ids. An unknown or
        non-integral id raises KeyError naming it; a quarantined one
        raises :class:`QuarantinedAgentError` with its reasons."""
        rows = np.empty(len(agent_ids), dtype=np.int32)
        for i, a in enumerate(agent_ids):
            try:
                ai = int(a)
                # int(17.9) == 17 would answer for the wrong agent
                if ai != a:
                    raise ValueError("non-integer id")
                if ai in self._quarantined:
                    raise QuarantinedAgentError(ai, self._quarantined[ai])
                rows[i] = self._id_to_row[ai]
            except QuarantinedAgentError:
                raise
            except (KeyError, TypeError, ValueError):
                raise KeyError(f"unknown agent_id {a!r}") from None
        return rows

    def year_index(self, year: Optional[int]) -> int:
        """Model-year index of a calendar year (default: the first model
        year); a year off the grid raises KeyError naming the grid."""
        if year is None:
            return 0
        try:
            yi = int(year)
            if yi != year:   # 2016.7 must not answer as 2016
                raise ValueError("non-integer year")
            return self._year_to_idx[yi]
        except (KeyError, TypeError, ValueError):
            raise KeyError(f"year {year!r} is not on the model grid {self.years}") from None

    def inputs_for(self, overrides: Optional[dict]) -> ScenarioInputs:
        """The (cached) ScenarioInputs variant of an override dict."""
        key = override_key(overrides)
        if not key:
            return self.sim.inputs
        with self._lock:
            cached = self._override_cache.get(key)
            if cached is not None:
                self._override_cache.move_to_end(key)
                return cached
        variant = apply_overrides(self.sim.inputs, overrides)
        with self._lock:
            self._override_cache[key] = variant
            while len(self._override_cache) > self._max_override_cache:
                self._override_cache.popitem(last=False)
        return variant

    # -- execution ------------------------------------------------------

    def query_rows(
        self,
        rows: np.ndarray,
        year_idx: int,
        inputs: Optional[ScenarioInputs] = None,
        bucket: Optional[int] = None,
        key: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """Run one bucket: table rows -> host result arrays ``[n, ...]``.

        ``bucket=None`` runs the request's own n rows; ``bucket=B`` pads
        them to B by repeating the first requested row (padding changes no
        answer, and keeps a mono-cluster bucket mono-cluster); either
        launches at least :data:`LAUNCH_ROW_FLOOR` rows
        (:func:`launch_rows`), and the first n answers come back.

        ``key``, the request's canonical override key (``""``: no
        override), unlocks the engine-free layers: a zero-override query
        for a year the surface covers answers from the surface, and a
        keyed bucket reads and feeds the result cache. ``key=None`` (the
        default) bypasses both.
        """
        # fault sites: a device failure on the serving path, a serving
        # process dying mid-query, a stall mid-query
        fault_point("serve_query")
        fault_point("serve_replica_kill")
        fault_point("serve_replica_hang")
        rows = np.asarray(rows, dtype=np.int32)
        n = rows.shape[0]
        if key == "" and self._surface is not None and self._surface.covers(year_idx):
            return self._surface.lookup(rows, year_idx)
        cache_key = None
        if key is not None and bucket is not None and self._result_cache is not None:
            cache_key = self._result_cache.key(year_idx, key, bucket, rows)
            hit = self._result_cache.get(cache_key)
            if hit is not None:
                return hit
        if bucket is not None and bucket < n:
            raise ValueError(f"bucket {bucket} < {n} requested rows")
        shape = n if bucket is None else bucket
        rows = launch_rows(rows, shape)
        statics = self._static_kwargs
        tariffs = self.sim.tariffs
        operands = {}
        if self._cluster is not None and rows.size:
            cids = self._cluster["cid"][rows]
            ci = int(cids[0])
            if np.all(cids == ci):
                statics = self._cluster["statics"][ci]
                tariffs = self._cluster["banks"][ci]
                operands = dict(cluster_tidx=self._cluster["tidx"])
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        with torch.no_grad():
            out = query_program(
                self.sim.table, self.sim.profiles, tariffs,
                inputs if inputs is not None else self.sim.inputs,
                idx, int(year_idx), **statics, **operands,
            )
            res = {f: getattr(out, f)[:n].cpu().numpy() for f in QUERY_FIELDS}
        with self._lock:
            self._warm.add(int(shape))
        if cache_key is not None:
            self._result_cache.put(cache_key, res)
        return res

    def query(
        self,
        agent_ids: Sequence[int],
        year: Optional[int] = None,
        overrides: Optional[dict] = None,
        bucket: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Direct query by stable agent id (the microbatcher is the
        serving path). Bypasses the surface and the cache: this is the
        oracle the engine-free paths are held to."""
        return self.query_rows(self.rows_for(agent_ids), self.year_index(year),
                               inputs=self.inputs_for(overrides), bucket=bucket)

    def warmup(self, buckets: Sequence[int], year_idx: int = 0) -> None:
        """Run every bucket once, so the kernel library is built and loaded
        before the first request: row 0 repeated, or under a clustered
        Simulation one representative row per cluster and one mixed
        bucket of two clusters' rows."""
        reps = [0]
        mixed = None
        if self._cluster is not None:
            cid = self._cluster["cid"]
            reps = [int(np.flatnonzero(cid == ci)[0])
                    for ci in range(len(self._cluster["banks"]))]
            if len(reps) > 1:
                mixed = reps[:2]
        for b in buckets:
            for r in reps:
                self.query_rows(np.full(b, r, dtype=np.int32), year_idx, bucket=None)
            if mixed is not None and b > 1:
                self.query_rows(
                    np.asarray(mixed * (b // 2) + [mixed[0]] * (b % 2), dtype=np.int32),
                    year_idx, bucket=None)
            logger.info("serve warmup: bucket %d run", b)
