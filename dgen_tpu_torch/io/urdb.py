"""URDB tooling: rate-record parsing, bulk download, tariff design (port
of ``dgen_tpu/io/urdb.py``, numpy only).

The reference ships three tariff utilities in ``tariff_functions.py``:
the ``Tariff`` class's URDB-record repackaging (tariff_functions.py:
230-330), the bulk URDB API downloader (``download_tariffs_from_urdb``,
:944) and ``design_tariff_for_portfolio`` (:1133), which builds a tariff
that extracts a target $/kWh from a load portfolio. This module gives
their equivalents, emitting spec dicts (compilable by
``ops.tariff.normalize_tariff_spec``; the demand spec is the dict a
demand-bank compiler takes) instead of a Python rate object:

* :func:`urdb_rate_to_specs`: one raw URDB API record (``energyrate
  structure`` period x tier dicts and 12x24 schedules) ->
  ``(energy_spec, demand_spec | None)``.
* :func:`download_tariffs_from_urdb`: the paginated API pull; the HTTP
  fetch is injectable, so an offline caller (and every test) supplies
  the records from disk.
* :func:`design_tariff_for_portfolio`: vectorized over the portfolio
  ([N, 8760] loads and weights), returning the specs and the achieved
  revenue split.

The arithmetic is float64, as in the JAX package, so the specs are the
same numbers.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dgen_tpu_torch.ops.tariff import (
    BIG_CAP,
    NET_METERING,
    expand_schedule_8760,
    hour_month_map,
)

URDB_API_URL = "https://api.openei.org/utility_rates"


def _rate_matrix(structure: List[List[dict]]) -> Tuple[np.ndarray, np.ndarray]:
    """URDB [period][tier] dicts -> (prices [T, P], levels [T, P]);
    price = rate + adj, missing caps unbounded — the reference's
    repackaging rule (tariff_functions.py:278-307)."""
    n_periods = len(structure)
    n_tiers = max((len(p) for p in structure), default=1)
    prices = np.zeros((n_tiers, n_periods))
    levels = np.full((n_tiers, n_periods), BIG_CAP)
    for p, period in enumerate(structure):
        for t, tier in enumerate(period):
            prices[t, p] = float(tier.get("rate", 0.0) or 0.0) + float(
                tier.get("adj", 0.0) or 0.0)
            mx = tier.get("max")
            if mx is not None and float(mx) > 0:
                levels[t, p] = float(mx)
    return prices, levels


def _schedule(record: dict, key: str, n_periods: int) -> Optional[np.ndarray]:
    """12x24 period schedule, with the reference's out-of-range rule:
    periods past the price table fall back to period 0
    (tariff_functions.py:318-323)."""
    sched = record.get(key)
    if sched is None:
        return None
    # np.array (copy), NOT np.asarray: when the record already holds an
    # int64 ndarray, asarray aliases it and the in-place remap below
    # would silently mutate the caller's data
    m = np.array(sched, np.int64)
    m[m >= n_periods] = 0
    return m


def urdb_rate_to_specs(
    record: Dict[str, Any],
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """One raw URDB API rate record -> (energy_spec, demand_spec).

    The energy spec carries the framework's legacy-layout keys
    (``e_prices`` [T][P] + 0-based 12x24 schedules — URDB schedules are
    already 0-based); the demand spec mirrors
    ``convert.reference_tariff_to_demand_spec``'s key set (flat prices
    per month via ``flatdemandmonths``, TOU structure + schedules), or
    None when the record prices no demand. Metering defaults to net
    metering, the reference's assumption for URDB pulls.
    """
    # .get defaults don't cover explicit JSON nulls (the API emits them)
    fixed = record.get("fixedmonthlycharge")
    if fixed is None:
        fixed = record.get("fixedchargefirstmeter")
    energy: Dict[str, Any] = {
        "fixed_charge": float(fixed or 0.0),
        "metering": int(record.get("metering") or NET_METERING),
    }
    es = record.get("energyratestructure")
    if es:
        prices, levels = _rate_matrix(es)
        energy["e_prices"] = prices.tolist()
        energy["e_levels"] = levels.tolist()
        n_p = prices.shape[1]
        for key, dst in (("energyweekdayschedule", "e_wkday_12by24"),
                         ("energyweekendschedule", "e_wkend_12by24")):
            sched = _schedule(record, key, n_p)
            if sched is not None:
                energy[dst] = sched.tolist()
    else:
        energy["price"] = [[0.1]]   # blank tariff -> inert flat rate

    demand: Dict[str, Any] = {}
    fd = record.get("flatdemandstructure")
    if fd:
        prices, levels = _rate_matrix(fd)          # [T, n_constructs]
        # .get default does not cover an explicit JSON null; np.array
        # copies so the in-place remap never mutates the record's own
        # ndarray (same aliasing hazard as _schedule), and the explicit
        # None/empty check replaces a truthiness test that raised on
        # ndarray-valued records
        fdm = record.get("flatdemandmonths")
        months = (
            np.array(fdm, np.int64) if fdm is not None and len(fdm)
            else np.zeros(12, np.int64)
        )
        months[months >= prices.shape[1]] = 0
        # per-month columns, the d_flat_* layout (tariff_functions.py:250)
        demand["d_flat_prices"] = prices[:, months].tolist()
        demand["d_flat_levels"] = levels[:, months].tolist()
    ds = record.get("demandratestructure")
    if ds:
        prices, levels = _rate_matrix(ds)
        if np.any(prices > 0):
            demand["d_tou_prices"] = prices.tolist()
            demand["d_tou_levels"] = levels.tolist()
            n_p = prices.shape[1]
            for key, dst in (("demandweekdayschedule", "d_wkday_12by24"),
                             ("demandweekendschedule", "d_wkend_12by24")):
                sched = _schedule(record, key, n_p)
                if sched is not None:
                    demand[dst] = sched.tolist()
    if demand and not np.any(
        np.asarray(demand.get("d_flat_prices", 0.0)) > 0
    ) and "d_tou_prices" not in demand:
        demand = {}
    return energy, (demand or None)


def download_tariffs_from_urdb(
    api_key: str,
    sector: Optional[str] = None,
    utility: Optional[str] = None,
    limit: int = 500,
    fetch: Optional[Callable[[str], bytes]] = None,
) -> List[Dict[str, Any]]:
    """Bulk-pull URDB rate records (reference
    tariff_functions.py:944-1000). Paginates until a short page.

    ``fetch`` is injectable (url -> response bytes); the default uses
    urllib, which requires network egress — in sealed environments pass
    a loader that reads saved API responses from disk.
    """
    from urllib.parse import urlencode

    if fetch is None:
        from urllib.request import urlopen

        fetch = lambda url: urlopen(url, timeout=60).read()  # noqa: S310

    records: List[Dict[str, Any]] = []
    offset = 0
    while True:
        params = {
            "version": 8, "format": "json", "api_key": api_key,
            "detail": "full", "limit": limit, "offset": offset,
        }
        if sector:
            params["sector"] = sector
        if utility:
            params["ratesforutility"] = utility
        url = f"{URDB_API_URL}?{urlencode(params)}"
        page = json.loads(fetch(url)).get("items", [])
        records.extend(page)
        if len(page) < limit:
            return records
        offset += limit


def design_tariff_for_portfolio(
    loads: np.ndarray,                 # [N, 8760] kW
    weights: np.ndarray,               # [N] customers represented
    avg_rev: float,                    # target $/kWh over the portfolio
    peak_hour_indices: Sequence[int],  # hours-of-day that are on-peak
    summer_month_indices: Sequence[int],
    rev_f_d: Sequence[float],          # [frac of rev, tou frac, flat frac]
    rev_f_e: Sequence[float],          # [frac of rev, peak frac, offpeak frac]
    rev_f_fixed: Sequence[float],      # [frac of rev]
) -> Dict[str, Any]:
    """Design a 2-period TOU + demand + fixed tariff extracting
    ``avg_rev`` $/kWh from the weighted portfolio (reference
    tariff_functions.py:1133-1256, vectorized over agents).

    Returns {"energy_spec", "demand_spec", "charges", "revenue_check"}:
    the two framework spec dicts plus the solved charge levels and the
    achieved revenue decomposition (the reference returns a Tariff
    object and leaves verification to a bill_calculator loop).

    Divergences from the reference, both deliberate:

    * the peak/off-peak windows use THIS framework's calendar
      (``expand_schedule_8760``, Jan-1 = Monday) rather than the
      reference's hard-coded Sunday-start — so ``revenue_check`` holds
      exactly under the framework's own bill engine for the emitted
      spec, which is the point of designing a tariff here;
    * the ``rev_f_e`` element order follows the reference's CODE
      (index 1 = peak, index 2 = off-peak,
      tariff_functions.py:1227-1228), not its docstring, which states
      the opposite — same docstring-vs-code resolution as the payback
      sentinel (ops/cashflow.py).
    """
    loads = np.asarray(loads, np.float64)
    weights = np.asarray(weights, np.float64)
    n, H = loads.shape
    if H != 8760:
        raise ValueError(f"loads must be [N, 8760], got {loads.shape}")

    wkday = np.zeros((12, 24), np.int64)
    wkend = np.zeros((12, 24), np.int64)
    for h in peak_hour_indices:
        wkday[np.asarray(summer_month_indices, np.int64), h] = 1
    period_8760 = np.asarray(expand_schedule_8760(wkday, wkend))
    month_idx = np.asarray(hour_month_map())

    # per-agent per-(month, period) maxes and sums, vectorized
    peak_d = np.zeros(n)     # sum over months of on-peak max kW
    flat_d = np.zeros(n)     # sum over months of all-hours max kW
    peak_e = np.zeros(n)     # annual on-peak kWh
    off_e = np.zeros(n)      # annual off-peak kWh
    on = period_8760 == 1
    for m in range(12):
        in_m = month_idx == m
        lm = loads[:, in_m]
        on_m = on[in_m]
        peak_d += np.max(
            np.where(on_m[None, :], lm, 0.0), axis=1)
        flat_d += np.max(lm, axis=1)
        peak_e += np.sum(np.where(on_m[None, :], lm, 0.0), axis=1)
        off_e += np.sum(np.where(on_m[None, :], 0.0, lm), axis=1)

    total_kwh = float(np.sum(weights * (peak_e + off_e)))
    norm_rev = total_kwh * float(avg_rev)
    rev = {
        "d_tou": norm_rev * rev_f_d[0] * rev_f_d[1],
        "d_flat": norm_rev * rev_f_d[0] * rev_f_d[2],
        # reference CODE order: [1] = peak, [2] = off-peak
        # (tariff_functions.py:1227-1228; its docstring says the
        # opposite — see the function docstring above)
        "e_peak": norm_rev * rev_f_e[0] * rev_f_e[1],
        "e_off": norm_rev * rev_f_e[0] * rev_f_e[2],
        "fixed": norm_rev * rev_f_fixed[0],
    }

    def _safe(num, den):
        return float(num / den) if den > 0 else 0.0

    charges = {
        "d_tou_peak": _safe(rev["d_tou"], np.sum(weights * peak_d)),
        "d_flat": _safe(rev["d_flat"], np.sum(weights * flat_d)),
        "e_peak": _safe(rev["e_peak"], np.sum(weights * peak_e)),
        "e_offpeak": _safe(rev["e_off"], np.sum(weights * off_e)),
        "fixed_monthly": _safe(rev["fixed"], np.sum(weights) * 12.0),
    }

    energy_spec = {
        # price [P, T]: period 0 off-peak, period 1 on-peak, one tier
        "price": [[charges["e_offpeak"]], [charges["e_peak"]]],
        "e_wkday_12by24": wkday.tolist(),
        "e_wkend_12by24": wkend.tolist(),
        "fixed_charge": charges["fixed_monthly"],
        "metering": NET_METERING,
    }
    demand_spec = {
        "d_flat_prices": [[charges["d_flat"]] * 12],
        "d_flat_levels": [[BIG_CAP] * 12],
        "d_tou_prices": [[0.0, charges["d_tou_peak"]]],
        "d_tou_levels": [[BIG_CAP, BIG_CAP]],
        "d_wkday_12by24": wkday.tolist(),
        "d_wkend_12by24": wkend.tolist(),
    }
    achieved = (
        charges["e_peak"] * np.sum(weights * peak_e)
        + charges["e_offpeak"] * np.sum(weights * off_e)
        + charges["d_tou_peak"] * np.sum(weights * peak_d)
        + charges["d_flat"] * np.sum(weights * flat_d)
        + charges["fixed_monthly"] * 12.0 * np.sum(weights)
    )
    return {
        "energy_spec": energy_spec,
        "demand_spec": demand_spec,
        "charges": charges,
        "revenue_check": {
            "target_usd": norm_rev,
            "achieved_usd": float(achieved),
            "avg_rev_per_kwh": _safe(achieved, total_kwh),
        },
    }
