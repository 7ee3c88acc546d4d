"""Trajectory and market-data ingest from the reference's input_data CSV
formats into dense host arrays (port of ``dgen_tpu/io/ingest.py``).

The reference ingests these CSVs into Postgres tables and merges them
onto the agent frame per year (input_data_functions.py:215
``import_table`` + the shapers at :272-560). Here each loader parses the
same on-disk schema directly to dense [year, ...] numpy arrays on the
model-year grid (nearest-year forward fill past the trajectory's end),
in the same dtypes and the same order of operations as the JAX package,
so the arrays are bit for bit its arrays. Nothing here needs pandas,
torch or a card: ``io.reference_inputs`` makes the tensors.

Supported formats (all observed under reference dgen_os/input_data/):
  * "stacked sector" files: ``year,<field>_res,<field>_com,<field>_ind``
    (pv_prices, pv_tech_performance, batt_prices via res/nonres,
    financing_terms via res/nonres).
  * load_growth: ``year,load_growth_res,load_growth_com,load_growth_ind,
    census_division_abbr``.
  * elec_prices: ``ba,year,elec_price_res,elec_price_com,elec_price_ind``.
  * observed deployment: ``state_abbr,sector_abbr,year,observed_solar_mw,...``.
  * attachment rates: ``state_abbr,metric,q2_24,...`` paired
    attachment_rate / install_volume rows (attachment_rate_functions.py:7).

Every read goes through :func:`_read_csv`, the ``ingest`` fault site
(``resilience.faults``): a transient input-read failure, which the run
supervisor classifies as retryable.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from dgen_tpu_torch.config import (
    BASS_DEFAULTS,
    PAYBACK_GRID_N,
    PAYBACK_GRID_STEP,
    SECTORS,
)
from dgen_tpu_torch.resilience.faults import fault_point

logger = logging.getLogger(__name__)


def _read_csv(path: str) -> List[Dict[str, str]]:
    # resilience drill hook: a transient input-read failure (network
    # filesystem flake) — retryable by the supervisor, never fatal
    fault_point("ingest", path=path)
    with open(path, newline="", encoding="utf-8-sig") as f:
        return list(csv.DictReader(f))


def _year_grid_interp(years_avail: np.ndarray, values: np.ndarray,
                      model_years: Sequence[int]) -> np.ndarray:
    """Sample a [Ya, ...] trajectory onto the model-year grid with
    nearest-neighbor-in-past semantics (forward fill; clamp at ends)."""
    out = []
    for y in model_years:
        i = int(np.searchsorted(years_avail, y, side="right")) - 1
        i = max(0, min(i, len(years_avail) - 1))
        out.append(values[i])
    return np.asarray(out)


def load_stacked_sectors(
    path: str,
    field: str,
    model_years: Sequence[int],
    nonres_suffix: bool = False,
) -> np.ndarray:
    """[Y, 3] array for ``<field>_res/_com/_ind`` (or ``_res/_nonres``
    when ``nonres_suffix``, duplicated to com+ind as the reference's
    stacked_sectors shaper does for batt prices / financing)."""
    rows = _read_csv(path)
    years = np.asarray([int(float(r["year"])) for r in rows])
    if nonres_suffix:
        cols = [f"{field}_res", f"{field}_nonres", f"{field}_nonres"]
    else:
        cols = [f"{field}_{s}" for s in SECTORS]
    vals = np.asarray([[float(r[c]) for c in cols] for r in rows], dtype=np.float32)
    order = np.argsort(years)
    return _year_grid_interp(years[order], vals[order], model_years).astype(np.float32)


def load_batt_tech(path: str, model_years: Sequence[int]) -> Dict[str, np.ndarray]:
    """batt_tech_performance CSV -> {"batt_eff": [Y, 3],
    "batt_lifetime_yrs": [Y, 3]} (columns ``batt_eff_res/com/ind`` +
    ``batt_lifetime_yrs_*``; reference apply_batt_tech_performance,
    agent_mutation/elec.py:319)."""
    return {
        "batt_eff": load_stacked_sectors(path, "batt_eff", model_years),
        "batt_lifetime_yrs": load_stacked_sectors(
            path, "batt_lifetime_yrs", model_years),
    }


def load_depreciation_schedules(
    path: str, model_years: Sequence[int], n_frac: int = 6
) -> np.ndarray:
    """depreciation_schedules CSV -> [Y, 3, D] fractions.

    Reference shape: one row per (year, sector_abbr) with columns
    ``1..D`` (agent_mutation/elec.py:157 ``apply_depreciation_schedule``
    merges the resulting list per agent). Sectors absent from the file
    (typically res) take the com schedule — depreciation only reaches
    non-commercial agents through ``is_commercial`` gating anyway.
    """
    rows = _read_csv(path)
    frac_cols = [str(i) for i in range(1, n_frac + 1)]
    by_sector: Dict[str, Dict[int, np.ndarray]] = {}
    for r in rows:
        sec = r.get("sector_abbr", "com")
        vals = np.asarray([float(r.get(c, 0.0) or 0.0) for c in frac_cols],
                          dtype=np.float32)
        by_sector.setdefault(sec, {})[int(float(r["year"]))] = vals
    if not by_sector:
        raise ValueError(f"no depreciation schedule rows in {path}")
    fallback = by_sector.get("com") or next(iter(by_sector.values()))
    out = np.zeros((len(model_years), len(SECTORS), n_frac), np.float32)
    for si, sec in enumerate(SECTORS):
        sched = by_sector.get(sec, fallback)
        years_avail = np.asarray(sorted(sched))
        vals = np.stack([sched[y] for y in sorted(sched)])
        out[:, si, :] = _year_grid_interp(years_avail, vals, model_years)
    # every schedule must distribute ~the full basis or none of it (the
    # reference ships all-zero res rows = no depreciation); files in
    # other semantics (e.g. the reference's deprec_sch_FY24.csv rows are
    # remaining-basis factors summing to ~4.9) would silently multiply
    # depreciation several-fold
    sums = out.sum(axis=-1)
    bad = (np.abs(sums - 1.0) > 0.05) & (np.abs(sums) > 0.05)
    if np.any(bad):
        raise ValueError(
            f"depreciation schedule rows in {path} sum to "
            f"{float(sums[bad].min()):.3f}..{float(sums[bad].max()):.3f}, "
            "expected ~1.0 (year-fraction schedule) or 0 (no "
            "depreciation); refusing to ingest"
        )
    return out


def load_carbon_intensities(
    path: str, model_years: Sequence[int], states: Sequence[str]
) -> np.ndarray:
    """carbon_intensities CSV (state_abbr + one column per year,
    tCO2/kWh) -> [Y, n_states] (reference apply_carbon_intensities,
    agent_mutation/elec.py:595, ingested via melt_year at
    dgen_model.py:215-216)."""
    rows = _read_csv(path)
    st_idx = {s: i for i, s in enumerate(states)}
    out = np.zeros((len(model_years), len(states)), np.float32)
    seen = set()
    for r in rows:
        s = r.get("state_abbr", "")
        if s not in st_idx:
            continue
        seen.add(s)
        year_cols = sorted(int(c) for c in r.keys() if c.isdigit())
        years_avail = np.asarray(year_cols)
        vals = np.asarray([float(r[str(y)]) for y in year_cols], np.float32)
        out[:, st_idx[s]] = _year_grid_interp(years_avail, vals, model_years)
    missing = [s for s in states if s not in seen]
    if missing:
        # the reference's left-merge would surface these as NaN
        # (elec.py:595); here they stay 0 — say so instead of silently
        # zeroing the emissions output
        logger.warning(
            "carbon_intensities: no rows for states %s (intensity 0)",
            missing,
        )
    return out


def load_financing_terms(path: str, model_years: Sequence[int]) -> Dict[str, np.ndarray]:
    """financing_terms CSV -> dict of [Y, 3] arrays (+ economic lifetime)."""
    out = {}
    for field in ("loan_term_yrs", "loan_interest_rate", "down_payment_fraction",
                  "real_discount_rate", "tax_rate"):
        out[field] = load_stacked_sectors(path, field, model_years, nonres_suffix=True)
    rows = _read_csv(path)
    out["economic_lifetime_yrs"] = int(float(rows[0]["economic_lifetime_yrs"]))
    return out


def load_load_growth(
    path: str,
    model_years: Sequence[int],
    regions: Sequence[str],
) -> np.ndarray:
    """load_growth CSV -> [Y, R, 3] multiplier array.

    The reference stores growth as a delta vs the base year per census
    division x sector; multiplier = 1 + growth.
    """
    rows = _read_csv(path)
    region_idx = {r: i for i, r in enumerate(regions)}
    by_region: Dict[int, Dict[int, List[float]]] = {}
    for r in rows:
        reg = r.get("census_division_abbr", "")
        if reg not in region_idx:
            continue
        y = int(float(r["year"]))
        by_region.setdefault(region_idx[reg], {})[y] = [
            1.0 + float(r[f"load_growth_{s}"]) for s in SECTORS
        ]
    Y, R, S = len(model_years), len(regions), len(SECTORS)
    out = np.ones((Y, R, S), dtype=np.float32)
    for reg_i, by_year in by_region.items():
        ys = np.asarray(sorted(by_year))
        vals = np.asarray([by_year[y] for y in ys], dtype=np.float32)
        out[:, reg_i, :] = _year_grid_interp(ys, vals, model_years)
    return out


def load_elec_prices(
    path: str,
    model_years: Sequence[int],
    bas: Sequence[str],
    base_year: Optional[int] = None,
) -> np.ndarray:
    """elec_prices CSV -> [Y, R, 3] retail price multiplier vs the base
    year (reference input_data_functions.py:450
    ``process_elec_price_trajectories`` normalizes to the 2016-equivalent
    base)."""
    rows = _read_csv(path)
    ba_idx = {b: i for i, b in enumerate(bas)}
    by_ba: Dict[int, Dict[int, List[float]]] = {}
    for r in rows:
        ba = r.get("ba", "")
        if ba not in ba_idx:
            continue
        y = int(float(r["year"]))
        by_ba.setdefault(ba_idx[ba], {})[y] = [
            float(r[f"elec_price_{s}"]) for s in SECTORS
        ]
    Y, R, S = len(model_years), len(bas), len(SECTORS)
    out = np.ones((Y, R, S), dtype=np.float32)
    for ba_i, by_year in by_ba.items():
        ys = np.asarray(sorted(by_year))
        vals = np.asarray([by_year[y] for y in ys], dtype=np.float32)
        b_year = base_year or int(ys[0])
        base = by_year.get(b_year, vals[0].tolist())
        traj = _year_grid_interp(ys, vals, model_years)
        out[:, ba_i, :] = traj / np.maximum(np.asarray(base, np.float32), 1e-9)
    return out


def load_observed_deployment(
    path: str,
    model_years: Sequence[int],
    states: Sequence[str],
) -> np.ndarray:
    """observed_deployment CSV -> [Y, G] cumulative observed PV kW,
    G = state x sector groups (reference
    diffusion_functions_elec.py:115-122 consumes observed_solar_mw)."""
    rows = _read_csv(path)
    st_idx = {s: i for i, s in enumerate(states)}
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    Y = len(model_years)
    G = len(states) * len(SECTORS)
    out = np.zeros((Y, G), dtype=np.float32)
    year_pos = {y: i for i, y in enumerate(model_years)}
    for r in rows:
        st = r.get("state_abbr", "")
        sec = r.get("sector_abbr", "")
        y = int(float(r["year"]))
        if st not in st_idx or sec not in sec_idx or y not in year_pos:
            continue
        g = st_idx[st] * len(SECTORS) + sec_idx[sec]
        out[year_pos[y], g] = float(r["observed_solar_mw"]) * 1000.0
    return out


def load_attachment_rates(path: str, states: Sequence[str]) -> np.ndarray:
    """ohm_attachment_rates CSV -> [n_states] install-volume-weighted
    average attachment rate (reference attachment_rate_functions.py:7-55).
    Falls back to the simple mean when volumes are missing/zero; clipped
    to [0, 1]; missing states get 0."""
    rows = _read_csv(path)
    qcols = [c for c in (rows[0].keys() if rows else []) if c.startswith("q")]
    rates: Dict[str, List[float]] = {}
    vols: Dict[str, List[float]] = {}
    for r in rows:
        st = r["state_abbr"].strip("﻿ ")
        vals = []
        for c in qcols:
            try:
                vals.append(float(r[c]))
            except (TypeError, ValueError):
                vals.append(np.nan)
        if r["metric"] == "attachment_rate":
            rates[st] = vals
        elif r["metric"] == "install_volume":
            vols[st] = vals
    out = np.zeros(len(states), dtype=np.float32)
    for i, st in enumerate(states):
        if st not in rates:
            continue
        rv = np.asarray(rates[st], dtype=float)
        wv = np.asarray(vols.get(st, [0.0] * len(rv)), dtype=float)
        wv = np.nan_to_num(wv)
        wsum = wv.sum()
        if wsum > 0:
            avg = np.nansum(rv * wv) / wsum
        else:
            avg = np.nanmean(rv)
        out[i] = float(np.clip(np.nan_to_num(avg), 0.0, 1.0))
    return out


def load_value_of_resiliency(path: str, states: Sequence[str]) -> np.ndarray:
    """value_of_resiliency CSV -> [G] $ per agent, G = state x sector.

    Schema per the reference's shipped ``vor_FY20_mid.csv``: one row per
    (state_abbr, sector_abbr) with ``value_of_resiliency_usd`` (merged
    onto agents by ``apply_value_of_resiliency``, agent_mutation/
    elec.py:287 — state+sector keyed, year-independent). Missing
    (state, sector) pairs stay 0 (the reference's left-merge NaN ->
    the kernel's no-VOR case; residential typically has no row)."""
    rows = _read_csv(path)
    st_idx = {s: i for i, s in enumerate(states)}
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    out = np.zeros(len(states) * len(SECTORS), dtype=np.float32)
    for r in rows:
        st, sec = r.get("state_abbr", ""), r.get("sector_abbr", "")
        if st in st_idx and sec in sec_idx:
            gi = st_idx[st] * len(SECTORS) + sec_idx[sec]
            out[gi] = float(r["value_of_resiliency_usd"])
    return out


def load_max_market_curves(path: str) -> np.ndarray:
    """max_market_curves CSV -> [S, PAYBACK_GRID_N] on the 0.1-yr grid.

    Schema mirrors the reference's ``max_market_curves_to_model`` view
    (data_functions.py:392-410): ``metric_value`` (payback years),
    ``sector_abbr``, ``max_market_share``, plus optional ``metric`` /
    ``business_model`` filters (kept: payback_period / host_owned, the
    rows the host-owned hot loop consumes). Curves are interpolated to
    tenths of a year and the 30.1 never-payback sentinel is pinned to
    exactly 0 (the reference's UNION ALL row, data_functions.py:399)."""
    rows = _read_csv(path)
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    pts: Dict[int, List[tuple]] = {i: [] for i in range(len(SECTORS))}
    for r in rows:
        if r.get("metric", "payback_period") != "payback_period":
            continue
        if r.get("business_model", "host_owned") != "host_owned":
            continue
        sec = r.get("sector_abbr", "")
        if sec not in sec_idx:
            continue
        pts[sec_idx[sec]].append(
            (float(r["metric_value"]), float(r["max_market_share"]))
        )
    grid = np.arange(PAYBACK_GRID_N, dtype=np.float64) * PAYBACK_GRID_STEP
    out = np.zeros((len(SECTORS), PAYBACK_GRID_N), dtype=np.float32)
    for si, p in pts.items():
        if not p:
            raise ValueError(
                f"{path}: no host_owned payback_period rows for sector "
                f"{SECTORS[si]!r}"
            )
        p.sort()
        xs = np.asarray([x for x, _ in p])
        ys = np.asarray([y for _, y in p])
        out[si] = np.interp(grid, xs, ys).astype(np.float32)
    out[:, -1] = 0.0  # the 30.1 sentinel row (data_functions.py:399-410)
    return out


def load_bass_params(
    path: str, states: Sequence[str],
    defaults: tuple = BASS_DEFAULTS,
) -> Dict[str, np.ndarray]:
    """bass_params CSV -> {"bass_p", "bass_q", "teq_yr1"} each [G].

    Schema mirrors the reference's ``input_solar_bass_params`` table
    (data_functions.py:300-306): state_abbr, p, q, teq_yr1, sector_abbr
    (+ optional ``tech``, filtered to solar when present). Groups with
    no row keep the synthetic defaults (and are reported by the caller
    via the returned ``missing`` count)."""
    rows = _read_csv(path)
    st_idx = {s: i for i, s in enumerate(states)}
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    g = len(states) * len(SECTORS)
    p = np.full(g, defaults[0], dtype=np.float32)
    q = np.full(g, defaults[1], dtype=np.float32)
    teq = np.full(g, defaults[2], dtype=np.float32)
    seen = np.zeros(g, dtype=bool)
    for r in rows:
        if r.get("tech", "solar") not in ("solar", ""):
            continue
        st, sec = r.get("state_abbr", ""), r.get("sector_abbr", "")
        if st not in st_idx or sec not in sec_idx:
            continue
        gi = st_idx[st] * len(SECTORS) + sec_idx[sec]
        p[gi] = float(r["p"])
        q[gi] = float(r["q"])
        teq[gi] = float(r["teq_yr1"])
        seen[gi] = True
    return {
        "bass_p": p, "bass_q": q, "teq_yr1": teq,
        "missing": int((~seen).sum()),
    }


def state_attachment_to_groups(per_state: np.ndarray, n_sectors: int = 3) -> np.ndarray:
    """[n_states] -> [G] by repeating across sectors (the reference
    merges the state-level rate onto every sector, dgen_model.py:408)."""
    return np.repeat(per_state, n_sectors).astype(np.float32)


def discover_reference_inputs(
    root: str, prefer: Optional[Dict[str, str]] = None
) -> Dict[str, str]:
    """Locate reference-format input files under an input_data directory.

    ``prefer`` maps family keys (pv_prices, elec_prices, financing, ...)
    to a filename substring — the scenario workbook's per-family
    trajectory selection (io.workbook) — which beats the built-in
    default substring; an unmatched preference falls back to the
    default rather than failing the whole ingest."""
    prefer = prefer or {}

    def first(sub: str, want: Optional[str]) -> Optional[str]:
        """Match ``want`` as a substring; None when unmatched (so the
        caller can chain fallbacks); ``want=None`` = alphabetical first."""
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            return None
        names = sorted(n for n in os.listdir(d) if n.endswith(".csv"))
        if not names:
            return None
        if want:
            for n in names:
                if want.lower() in n.lower():
                    return os.path.join(d, n)
            return None
        return os.path.join(d, names[0])

    out = {}
    for key, sub, default in (
        ("pv_prices", "pv_prices", "mid"),
        ("pv_tech", "pv_tech_performance", "FY19"),
        ("batt_prices", "batt_prices", "mid"),
        ("financing", "financing_terms", "FY19"),
        ("load_growth", "load_growth", None),
        ("elec_prices", "elec_prices", "Mid_Case"),
        ("batt_tech", "batt_tech_performance", "FY19"),
        ("deprec", "depreciation_schedules", "FY19"),
    ):
        p = (first(sub, prefer.get(key)) or first(sub, default)
             or first(sub, None))
        if p:
            out[key] = p
    for key, name in (
        ("observed", "observed_deployment_by_state_sector_2023.csv"),
        ("attachment", "ohm_attachment_rates.csv"),
    ):
        p = os.path.join(root, name)
        if os.path.exists(p):
            out[key] = p
    return out
