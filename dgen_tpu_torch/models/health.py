"""The numerical-health sentinel (port of ``dgen_tpu/models/health.py``):
small on-device reductions over each year's outputs, checked on the host.

* :func:`health_summary`: for each monitored ``YearOutputs`` leaf, the
  count of nonfinite values and of finite values outside the leaf's
  gross bounds, over real (mask 1) agents: a ``[C, 2]`` int32 tensor on
  the outputs' device.
* :func:`check_host`: the verdict over the fetched summary.
* :func:`breach_error`: the offending agents of a breach, from the
  breached per-agent leaves, as a :class:`HealthBreachError` naming
  their stable ids.

The bounds are loose on purpose (orders of magnitude beyond any
reachable value): the sentinel catches poison, NaN/inf and 1e30-style
garbage, and does not police modeling choices.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

#: (YearOutputs leaf, lower, upper): nonfinite always counts; finite
#: values outside [lower, upper] count as bound breaches
HEALTH_CHECKS: Tuple[Tuple[str, float, float], ...] = (
    ("npv", -1e14, 1e14),
    ("payback_period", -1e-3, 1e3),
    ("system_kw", -1e-3, 1e9),
    ("batt_kw", -1e-3, 1e9),
    ("batt_kwh", -1e-3, 1e10),
    ("first_year_bill_with_system", -1e12, 1e12),
    ("first_year_bill_without_system", -1e12, 1e12),
    ("cash_flow", -1e14, 1e14),
    ("max_market_share", -1e-3, 10.0),
    ("market_share", -1e-3, 10.0),
    ("number_of_adopters", -1e-3, 1e12),
    ("system_kw_cum", -1e-3, 1e13),
)

#: leaves that are pure functions of one agent's own inputs (the sizing
#: and bill engine): a bad row there is a root cause. Market-step leaves
#: mix agents through group sums, so they attribute a breach only when
#: no per-agent leaf breached.
ATTRIBUTION_LEAVES = frozenset((
    "npv", "payback_period", "system_kw", "batt_kw", "batt_kwh",
    "first_year_bill_with_system", "first_year_bill_without_system",
    "cash_flow",
))

#: more offending rows than this and the report is truncated (it says
#: so). The JAX package's cap is 4096; the port's is the quarantine cap
#: (resilience.quarantine.MAX_QUARANTINE), because the run supervisor
#: quarantines exactly the attributed agents: a bank row referenced by
#: more than 4096 agents (one of the 12 synthetic load rows at 32,768
#: agents) would otherwise be contained only in part, and a corruption
#: that does not recur would leave the rest in the run.
MAX_ATTRIBUTED = 65536


class HealthBreachError(RuntimeError):
    """Nonfinite or out-of-bounds values in a model year's outputs.
    ``agent_ids`` (when attribution succeeded) are the offending agents'
    stable ids."""

    def __init__(
        self,
        year: int,
        year_idx: int,
        breaches: List[dict],
        agent_rows: Sequence[int] = (),
        agent_ids: Sequence[int] = (),
        truncated: bool = False,
    ) -> None:
        leaves = ", ".join(
            f"{b['leaf']} (nonfinite={b['nonfinite']}, "
            f"out_of_bounds={b['out_of_bounds']})"
            for b in breaches
        )
        ids = list(agent_ids)
        super().__init__(
            f"numerical-health breach at year {year}: {leaves}"
            + (
                f"; attributed to {len(ids)} agent(s) "
                f"{ids[:8]}{'...' if len(ids) > 8 else ''}"
                + (" [truncated]" if truncated else "")
                if ids else "; unattributed"
            )
        )
        self.year = int(year)
        self.year_idx = int(year_idx)
        self.breaches = list(breaches)
        self.agent_rows = tuple(int(r) for r in agent_rows)
        self.agent_ids = tuple(int(a) for a in ids)
        self.truncated = bool(truncated)


def health_summary(outs, mask: torch.Tensor, reduce=None) -> torch.Tensor:
    """[C, 2] int32 on the outputs' device: per :data:`HEALTH_CHECKS`
    row, (nonfinite count, finite-but-out-of-bounds count) over the
    agents with ``mask > 0``; padding rows never count. ``reduce`` (a
    multi-rank run's ``parallel.mesh.CrossRank``): the counts over every
    rank's rows, so every rank reaches the same verdict (the attribution
    names each rank's own offending agents)."""
    keep = mask > 0
    rows = []
    for name, lo, hi in HEALTH_CHECKS:
        x = getattr(outs, name)
        k = keep if x.ndim == 1 else keep[:, None]
        finite = torch.isfinite(x)
        nonf = (~finite & k).sum(dtype=torch.int32)
        oob = (finite & ((x < lo) | (x > hi)) & k).sum(dtype=torch.int32)
        rows.append(torch.stack([nonf, oob]))
    out = torch.stack(rows)
    return out if reduce is None else reduce.combine(out)


def check_host(summary) -> List[dict]:
    """The breached checks of a summary as ``[{"leaf", "nonfinite",
    "out_of_bounds"}, ...]`` (empty = clean)."""
    s = summary.cpu().numpy() if isinstance(summary, torch.Tensor) else np.asarray(summary)
    out = []
    for (name, _, _), (nonf, oob) in zip(HEALTH_CHECKS, s):
        if nonf or oob:
            out.append({
                "leaf": name,
                "nonfinite": int(nonf),
                "out_of_bounds": int(oob),
            })
    return out


def attribute(outs, breaches: List[dict], mask_host: np.ndarray
              ) -> Tuple[np.ndarray, bool]:
    """Offending rows (sorted) of a breach: the union of the bad real
    rows of the breached per-agent leaves (:data:`ATTRIBUTION_LEAVES`),
    or of every breached leaf when no per-agent leaf breached. Returns
    ``(rows, truncated)``."""
    names = [b["leaf"] for b in breaches if b["leaf"] in ATTRIBUTION_LEAVES]
    if not names:
        names = [b["leaf"] for b in breaches]
    bounds = {name: (lo, hi) for name, lo, hi in HEALTH_CHECKS}
    keep = np.asarray(mask_host) > 0
    bad_rows: set = set()
    for name in names:
        lo, hi = bounds[name]
        leaf = getattr(outs, name, None)
        if leaf is None:
            continue
        vals = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        flat = vals.reshape(vals.shape[0], -1)
        finite = np.isfinite(flat)
        bad = ~finite | (finite & ((flat < lo) | (flat > hi)))
        rows = np.flatnonzero(bad.any(axis=1))
        bad_rows.update(int(r) for r in rows[keep[rows]])
    rows = np.asarray(sorted(bad_rows), dtype=np.int64)
    return rows[:MAX_ATTRIBUTED], rows.size > MAX_ATTRIBUTED


def breach_error(year, year_idx, breaches: List[dict], outs,
                 agent_ids_host: np.ndarray,
                 mask_host: np.ndarray) -> HealthBreachError:
    """The attributed :class:`HealthBreachError` of a breached year: the
    offending rows, then row -> stable agent id through the host copy
    of the ids (``outs=None``: unattributed)."""
    if outs is None:
        rows, truncated = np.asarray([], dtype=np.int64), False
    else:
        rows, truncated = attribute(outs, breaches, mask_host)
    ids = np.asarray(agent_ids_host)[rows] if rows.size else np.asarray([], np.int64)
    return HealthBreachError(
        year, year_idx, breaches,
        agent_rows=rows.tolist(), agent_ids=ids.tolist(),
        truncated=truncated,
    )
