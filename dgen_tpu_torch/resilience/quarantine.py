"""Bad-data quarantine: load-time validation of the agent table and the
profile and tariff banks, with per-agent containment instead of run-wide
poisoning (port of ``dgen_tpu/resilience/quarantine.py``).

A single NaN agent spreads through the state battery-adopter sort and
the diffusion group sums and corrupts every agent in its state; at
national width malformed rows (non-finite loads, broken int8 scales,
out-of-range tariff references, negative prices) are to be expected.

* :func:`validate_population`: finiteness, range and reference checks
  over the agent table, the profile banks (int8 scale sidecars included)
  and the tariff bank, giving a :class:`QuarantineReport` of per-agent
  reasons and bad bank rows. The JAX package checks host copies; here
  every flag is computed where the tensors lie (on the card in a run)
  and only the per-check counts, then the flagged row numbers and their
  ids, come to the host: no column is copied whole.
* :func:`apply_quarantine`: the report's rows rewritten, with
  ``torch.where`` on their device, to the inert fills that padding rows
  carry (mask 0, bank indices 0, ``models.agents._PAD_FILLS``, zeroed
  incentives), and unreadable bank rows zeroed (int8 scales to 1.0), so
  quarantined agents contribute exact zeros to bills, sizing, the
  adopter sort and the state sums. Shapes and dtypes do not change, and
  a clean report returns the very same objects, so a clean run launches
  what it launched before, bit for bit.
* :class:`QuarantineReport` round-trips through an atomic
  ``quarantine.json`` (the JAX package's schema, version 1), which the
  run supervisor records in the run manifest.

The health sentinel (:mod:`dgen_tpu_torch.models.health`) catches
corruption that appears mid-run; the supervisor's escalation brings its
attributed agents back here through ``RunConfig.quarantine_ids``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from dgen_tpu_torch.models.agents import _PAD_FILLS
from dgen_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger(__name__)

#: report schema version (quarantine.json)
_VERSION = 1

#: bound on how many agents one validation/attribution pass will
#: quarantine — a report bigger than this almost certainly means the
#: INPUTS are the wrong file, not that 100k rows each went bad
MAX_QUARANTINE = 65536


class QuarantinedAgentError(Exception):
    """A request addressed a quarantined agent (the JAX package's serve
    layer maps this to HTTP 422: the row exists but its data was
    contained at load); carries the machine-readable reasons."""

    def __init__(self, agent_id: int, reasons: Sequence[str]) -> None:
        super().__init__(
            f"agent {agent_id} is quarantined ({'; '.join(reasons)})"
        )
        self.agent_id = int(agent_id)
        self.reasons = list(reasons)


@dataclasses.dataclass
class QuarantineReport:
    """Reasoned per-agent quarantine decisions + bad bank rows.

    ``records`` maps stable agent id -> ``{"row": int, "reasons":
    [str, ...]}``; ``bank_rows`` maps a ProfileBank field name to the
    sorted bad row indices that :func:`apply_quarantine` must zero
    (every agent referencing them is quarantined, so zeroing is
    output-invariant)."""

    n_agents: int = 0
    records: Dict[int, dict] = dataclasses.field(default_factory=dict)
    bank_rows: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    context: str = "load"

    # -- construction ---------------------------------------------------

    def add(self, agent_id: int, row: int, reason: str) -> None:
        rec = self.records.setdefault(
            int(agent_id), {"row": int(row), "reasons": []}
        )
        if reason not in rec["reasons"]:
            rec["reasons"].append(reason)

    def add_ids(self, ids: Iterable[int], reason: str) -> None:
        """Quarantine agents by stable id alone (operator/config fiat,
        the supervisor's sentinel escalation round-trip)."""
        for a in ids:
            self.add(int(a), -1, reason)

    def add_bank_row(self, field: str, row: int) -> None:
        rows = self.bank_rows.setdefault(field, [])
        if int(row) not in rows:
            rows.append(int(row))
            rows.sort()

    def merge(self, other: "QuarantineReport") -> None:
        for a, rec in other.records.items():
            for reason in rec["reasons"]:
                self.add(int(a), rec.get("row", -1), reason)
        for field, rows in other.bank_rows.items():
            for r in rows:
                self.add_bank_row(field, r)

    # -- queries --------------------------------------------------------

    @property
    def n_quarantined(self) -> int:
        return len(self.records)

    @property
    def ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self.records))

    @property
    def is_clean(self) -> bool:
        return not self.records and not any(self.bank_rows.values())

    def reasons_for(self, agent_id: int) -> List[str]:
        rec = self.records.get(int(agent_id))
        return list(rec["reasons"]) if rec else []

    def reason_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.records.values():
            for reason in rec["reasons"]:
                out[reason] = out.get(reason, 0) + 1
        return out

    def summary(self) -> Dict[str, object]:
        """The compact provenance block exporters stamp into meta.json
        beside ``nonfinite_zeroed``."""
        return {
            "context": self.context,
            "n_agents": int(self.n_agents),
            "n_quarantined": self.n_quarantined,
            "reasons": self.reason_counts(),
            "bank_rows": {
                k: list(v) for k, v in self.bank_rows.items() if v
            },
        }

    # -- persistence ----------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        return {
            "version": _VERSION,
            "context": self.context,
            "n_agents": int(self.n_agents),
            "n_quarantined": self.n_quarantined,
            "agents": {
                str(a): self.records[a] for a in sorted(self.records)
            },
            "bank_rows": {
                k: list(v) for k, v in self.bank_rows.items() if v
            },
        }

    def save(self, path: str) -> None:
        """Publish the report atomically (temp + rename): a killed
        writer can never leave truncated JSON at the published path."""
        atomic_write_json(path, self.to_json(), indent=1)

    @classmethod
    def from_json(cls, blob: Dict[str, object]) -> "QuarantineReport":
        rep = cls(
            n_agents=int(blob.get("n_agents", 0)),
            context=str(blob.get("context", "load")),
        )
        for a, rec in (blob.get("agents") or {}).items():
            for reason in rec.get("reasons", ()):
                rep.add(int(a), int(rec.get("row", -1)), reason)
        for field, rows in (blob.get("bank_rows") or {}).items():
            for r in rows:
                rep.add_bank_row(field, int(r))
        return rep

    @classmethod
    def load(cls, path: str) -> "QuarantineReport":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

#: per-agent float columns checked for finiteness (and, where listed
#: below, range). The documented sentinels (nem_kw_limit and the switch
#: window at 1e30, the sunset at 9999) are finite and in range by design.
_FLOAT_COLS = (
    "customers_in_bin", "load_kwh_per_customer_in_bin",
    "developable_frac", "one_time_charge", "nem_kw_limit",
    "nem_first_year", "nem_sunset_year", "switch_min_kw",
    "switch_max_kw",
)

#: (column, lower, upper) inclusive range checks over finite values; the
#: bounds are loose on purpose: they catch corruption (negative loads,
#: 1e38 garbage), not modeling choices
_RANGE_COLS = (
    ("customers_in_bin", 0.0, 1e12),
    ("load_kwh_per_customer_in_bin", 0.0, 1e12),
    ("developable_frac", -1e-6, 1.0 + 1e-6),
    ("one_time_charge", 0.0, 1e9),
)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _any_but_first(bad: torch.Tensor) -> torch.Tensor:
    """[K, ...] -> [K]: any over every axis but the first."""
    return bad.reshape(bad.shape[0], -1).any(dim=1) if bad.ndim > 1 else bad


def _sidecar_bad(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[R] bool on the tensors' device: the rows of an int8 bank whose
    float32 scale destroys them (see :func:`quant_sidecar_bad_rows`)."""
    finite = torch.isfinite(scales)
    bad = ~finite | (scales < 0)
    zero = finite & (scales == 0)
    return bad | (zero & (codes != 0).reshape(codes.shape[0], -1).any(dim=1))


def quant_sidecar_bad_rows(codes, scales) -> np.ndarray:
    """Bad row indices of an int8 quant bank's float32 scale sidecar.

    A non-finite or negative scale destroys the row (dequantization is
    ``scale * code``); a zero scale is the all-zero-row floor
    (``models.agents.quantize_rows`` stores 1.0, an external writer may
    store 0.0: dequantization is exact zero either way) and is valid
    only while every code in the row is zero: a zero scale under nonzero
    codes silently flattens real data to zero. Takes tensors (on any
    device) or numpy arrays."""
    bad = _sidecar_bad(_as_tensor(codes), _as_tensor(scales))
    return torch.nonzero(bad).flatten().cpu().numpy()


def _bad_bank_rows(bank: torch.Tensor, scales=None, nonneg: bool = True
                   ) -> torch.Tensor:
    """[R] bool on the bank's device: rows that cannot be priced (any
    non-finite element, any negative one for banks that are nonnegative
    by construction, or a broken int8 scale)."""
    if bank.dtype == torch.int8:
        # codes are always finite; the sidecar is the risk
        bad = torch.zeros(bank.shape[0], dtype=torch.bool, device=bank.device)
    else:
        a = bank.float()
        finite = torch.isfinite(a)
        bad = ~finite.all(dim=1)
        if nonneg:
            bad = bad | (torch.where(finite, a, torch.zeros_like(a)) < 0).any(dim=1)
    if scales is not None:
        bad = bad | _sidecar_bad(bank, scales)
    return bad


def _rows(bad: torch.Tensor) -> np.ndarray:
    """Host row numbers of a device flag vector."""
    return torch.nonzero(bad).flatten().cpu().numpy()


def validate_population(table, profiles=None, tariffs=None,
                        context: str = "load") -> QuarantineReport:
    """Load-time validation of a population on its device: finiteness,
    range and reference checks of the per-agent columns, bank-reference
    bounds, unusable profile-bank rows (int8 scale sidecars included) and
    unusable tariff rows, over the real (mask 1) rows only: padding is
    inert by construction. The checks, their order, the reasons and the
    refusal past :data:`MAX_QUARANTINE` are the JAX package's. The flags
    are computed where the tensors lie; one fetch brings every check's
    count to the host, and a check with hits brings its row numbers and
    their ids. Returns the reasoned :class:`QuarantineReport`."""
    mask = table.mask > 0
    rep = QuarantineReport(n_agents=int(mask.sum()), context=context)
    checks: List[Tuple[torch.Tensor, str]] = []

    def flag(bad: torch.Tensor, reason: str) -> None:
        checks.append((bad & mask, reason))

    # 1. finiteness of the per-agent float columns and incentive leaves
    for name in _FLOAT_COLS:
        flag(~torch.isfinite(getattr(table, name)), f"nonfinite:{name}")
    inc = getattr(table, "incentives", None)
    if inc is not None:
        for f in dataclasses.fields(type(inc)):
            leaf = getattr(inc, f.name)
            if leaf.is_floating_point():
                flag(_any_but_first(~torch.isfinite(leaf)),
                     f"nonfinite:incentives.{f.name}")

    # 2. gross range checks
    for name, lo, hi in _RANGE_COLS:
        col = getattr(table, name)
        flag(torch.isfinite(col) & ((col < lo) | (col > hi)), f"range:{name}")

    # 3. bank and tariff reference bounds
    bounds = [("state_idx", int(table.n_states)),
              ("sector_idx", int(table.n_sectors))]
    if profiles is not None:
        bounds += [
            ("load_idx", int(profiles.load.shape[0])),
            ("cf_idx", int(profiles.solar_cf.shape[0])),
            ("region_idx", int(profiles.wholesale.shape[0])),
        ]
    if tariffs is not None:
        n_t = int(tariffs.metering.shape[0])
        bounds += [("tariff_idx", n_t), ("tariff_switch_idx", n_t)]
    for name, n in bounds:
        col = getattr(table, name)
        flag((col < 0) | (col >= n), f"index:{name}")

    # 4. unusable profile-bank rows: the rows are remembered for zeroing
    # and every agent referencing one is quarantined
    if profiles is not None:
        for field, idx_name, scale_name, nonneg in (
            ("load", "load_idx", "load_scale", True),
            ("solar_cf", "cf_idx", "solar_cf_scale", True),
            # real wholesale prices go negative; only non-finite is bad
            ("wholesale", "region_idx", None, False),
        ):
            bank = getattr(profiles, field)
            scales = getattr(profiles, scale_name) if scale_name else None
            bad_rows = _rows(_bad_bank_rows(bank, scales, nonneg=nonneg))
            idx = getattr(table, idx_name)
            inb = (idx >= 0) & (idx < bank.shape[0])
            for r in bad_rows:
                rep.add_bank_row(field, int(r))
                flag(inb & (idx == int(r)), f"bank:{field}[{int(r)}]")

    # 5. unusable tariff rows (non-finite anywhere, a negative buy price)
    if tariffs is not None:
        price = tariffs.price.float()
        finite = torch.isfinite(price)
        bad_t = _any_but_first(~finite) | _any_but_first(
            torch.where(finite, price, torch.zeros_like(price)) < 0)
        for name in ("sell_price", "tier_cap", "fixed_monthly"):
            bad_t = bad_t | _any_but_first(~torch.isfinite(getattr(tariffs, name).float()))
        bad_rows = _rows(bad_t)
        for r in bad_rows:
            rep.add_bank_row("tariff", int(r))
        n_t = price.shape[0]
        for idx_name in ("tariff_idx", "tariff_switch_idx"):
            idx = getattr(table, idx_name)
            inb = (idx >= 0) & (idx < n_t)
            for r in bad_rows:
                flag(inb & (idx == int(r)), f"tariff:[{int(r)}]")

    # one fetch of every check's count, then rows only where a check hit
    counts = torch.stack([b.sum() for b, _ in checks]).cpu().numpy()
    for (bad, reason), count in zip(checks, counts):
        # refuse before building per-row records: a wholesale-corrupt
        # column at national width refuses at once
        if rep.n_quarantined + int(count) > MAX_QUARANTINE:
            _refuse(rep, reason)
        if not count:
            continue
        rows = torch.nonzero(bad).flatten()
        for a, r in zip(table.agent_id[rows].cpu().numpy(), rows.cpu().numpy()):
            rep.add(int(a), int(r), reason)

    if rep.n_quarantined > MAX_QUARANTINE:
        raise ValueError(
            f"validation would quarantine {rep.n_quarantined} of "
            f"{rep.n_agents} agents (> {MAX_QUARANTINE}); this is an "
            "input-file problem, not row corruption — refusing to mask "
            "it (reasons: "
            f"{sorted(rep.reason_counts())[:5]})"
        )
    return rep


def _refuse(rep: QuarantineReport, reason: str) -> None:
    raise ValueError(
        f"validation would quarantine more than {MAX_QUARANTINE} "
        f"of {rep.n_agents} agents (first overflow at "
        f"'{reason}'); this is an input-file problem, not row "
        "corruption — refusing to mask it (reasons so far: "
        f"{sorted(rep.reason_counts())[:5]})"
    )


# ---------------------------------------------------------------------------
# Containment
# ---------------------------------------------------------------------------

def apply_quarantine(table, profiles, report: QuarantineReport):
    """Contain a report's rows on their device: quarantined agents become
    padding (mask 0, bank indices 0, the ``_PAD_FILLS`` fills, zeroed
    incentives: the layout ``models.agents.pad_table`` gives padding rows,
    so they contribute exact zeros wherever padding does), and unreadable
    profile-bank rows are zeroed (int8 scales set to 1.0), so daylight
    layouts, quantization and whole-bank passes stay NaN-free. The stable
    ``agent_id`` is kept. Every rewrite is a ``torch.where`` (or a row
    assignment on a copy of a bank) where the tensor lies. Returns
    ``(table, profiles)``; a clean report returns the inputs themselves
    (object identity)."""
    if report.is_clean:
        return table, profiles

    ids = torch.as_tensor(np.asarray(report.ids, dtype=np.int64),
                          device=table.agent_id.device)
    q = torch.isin(table.agent_id.long(), ids) & (table.mask > 0)
    if bool(q.any()):
        def where_q(col, fill):
            shaped = q.reshape((-1,) + (1,) * (col.ndim - 1))
            return torch.where(shaped, torch.full((), fill, dtype=col.dtype,
                                                  device=col.device), col)

        repl = {}
        for f in dataclasses.fields(type(table)):
            if f.name in ("incentives", "n_states", "agent_id", "mask"):
                continue
            repl[f.name] = where_q(getattr(table, f.name), _PAD_FILLS.get(f.name, 0))
        repl["mask"] = where_q(table.mask, 0.0)
        inc = table.incentives
        inc_repl = {f.name: where_q(getattr(inc, f.name), 0)
                    for f in dataclasses.fields(type(inc))}
        table = dataclasses.replace(
            table, incentives=dataclasses.replace(inc, **inc_repl), **repl)

    bank_repl = {}
    for field, scale_name in (("load", "load_scale"),
                              ("solar_cf", "solar_cf_scale"),
                              ("wholesale", None)):
        rows = report.bank_rows.get(field) or []
        if not rows:
            continue
        bank = getattr(profiles, field)
        rows_t = torch.as_tensor(rows, dtype=torch.long, device=bank.device)
        arr = bank.clone()
        arr[rows_t] = 0
        bank_repl[field] = arr
        if scale_name and getattr(profiles, scale_name, None) is not None:
            sc = getattr(profiles, scale_name).clone()
            sc[rows_t] = 1.0
            bank_repl[scale_name] = sc
    if bank_repl:
        profiles = dataclasses.replace(profiles, **bank_repl)

    logger.warning(
        "quarantine: contained %d agent(s)%s — reasons %s",
        report.n_quarantined,
        "".join(
            f", zeroed {len(v)} {k} bank row(s)"
            for k, v in report.bank_rows.items()
            if v and k != "tariff"
        ),
        report.reason_counts(),
    )
    return table, profiles
