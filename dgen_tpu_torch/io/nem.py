"""NEM policy machine (port of ``dgen_tpu/io/nem.py``): compile
reference-format net-metering policy data into the dense gates the year
step consumes. Host-side numpy. The state capacity caps compile from
parsed CSV rows (:func:`compile_state_nem_caps_rows`, what the ingest of
an input root calls on the card path, where there is no pandas);
:func:`compile_state_nem_caps` and :func:`resolve_agent_nem_policy` take
DataFrames and import pandas inside, on the CPU side.

The reference re-derives NEM availability every model year from four
tables (reference agent_mutation/elec.py:459 ``get_nem_settings``):
state capacity limits (``nem_state_limits_2019``), state x sector and
utility x sector scenario attributes (``nem_scenario_bau_2019`` /
``..._by_utility_2019``, reference data_functions.py:648-733), plus
per-state peak demand and solar CF during the peak period
(``peak_demand_mw.csv`` / ``cf_during_peak_demand.csv`` read every year
at dgen_model.py:253-254). Here the whole machine is compiled ONCE at
ingest into:

  * ``nem_cap_kw [Y, n_states]`` — the installed-capacity ceiling under
    which NEM stays open (:func:`compile_state_nem_caps`), consumed by
    the year step's cumulative-capacity gate.
  * per-agent ``nem_kw_limit`` / ``nem_first_year`` / ``nem_sunset_year``
    (:func:`resolve_agent_nem_policy`) — the system-size limit and
    availability window after utility-overrides-state resolution
    (reference elec.py:92-119 ``apply_export_tariff_params``),
    consumed as a sizing-bracket cap + metering gate.

Divergences from the reference, on purpose:
  * The capacity gate compares against the PREVIOUS model step's state
    cumulative (the reference's ``max_reference_year='previous'``
    branch, elec.py:466); the 'current' variant is indistinguishable in
    practice because ``state_capacity_by_year`` is always built from
    last year's outputs before sizing runs (dgen_model.py:257-260).
  * A state absent from ``state_limits`` — or outside its
    [first_year, sunset_year] window — carries NO capacity cap (the
    reference's left-merge keeps such states with null caps and every
    null-cap filter passes, elec.py:470-478).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

#: "no limit" sentinel, well inside float32
NO_CAP = 1e30

#: the cells pandas' ``read_csv`` reads as missing (its default
#: ``na_values``, and the empty cell)
_NA_CELLS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _num(df, col: str):
    import pandas as pd

    if col not in df.columns:
        return pd.Series(np.nan, index=df.index)
    return pd.to_numeric(df[col], errors="coerce")


def _num_cell(v) -> float:
    """A cell as a float, NaN where it is missing or not a number: what
    ``pd.to_numeric(..., errors="coerce")`` makes of a ``read_csv`` cell.
    Text goes through Python's ``float`` (correctly rounded), with the
    spellings Python alone accepts (digit separators) refused."""
    if v is None:
        return float("nan")
    if isinstance(v, (int, float, np.integer, np.floating)):
        return float(v)
    text = str(v).strip()
    if text in _NA_CELLS or "_" in text:
        return float("nan")
    try:
        return float(text)
    except ValueError:
        return float("nan")


def compile_state_nem_caps_rows(
    state_limits: Sequence[Mapping[str, object]],
    peak_demand_mw: Optional[Sequence[Mapping[str, object]]],
    cf_during_peak: Optional[Sequence[Mapping[str, object]]],
    years: Sequence[int],
    states: Sequence[str],
    res_load_multiplier: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[Y, n_states] float32 NEM capacity cap in kW, from rows (``csv.
    DictReader`` rows as ``io.ingest._read_csv`` returns them, or
    records of parsed values).

    Per (year, state), within the state-limits row's availability
    window, the cap is the tighter of (reference elec.py:474-478):

      * ``max_cum_capacity_mw`` (absolute MW ceiling), and
      * ``max_pct_cum_capacity``% of peak demand converted to nameplate
        MW via the solar CF during the peak-demand period:
        ``max_pct/100 * peak_demand_mw(year) / cf_peak`` (elec.py:477).

    ``peak_demand_mw(year)`` scales the 2014 base by the residential
    load-growth multiplier, the reference's peak-demand tracking
    (calc_state_capacity_by_year, elec.py:813-814);
    ``res_load_multiplier [Y, n_states]`` defaults to 1.0.
    """
    ny, ns = len(years), len(states)
    caps = np.full((ny, ns), NO_CAP, dtype=np.float32)
    if not state_limits:
        return caps

    st_idx = {s: i for i, s in enumerate(states)}
    peak = {
        str(r["state_abbr"]): _num_cell(r["peak_demand_mw_2014"])
        for r in peak_demand_mw
    } if peak_demand_mw is not None else {}
    cf = {
        str(r["state_abbr"]): _num_cell(r["solar_cf_during_peak_demand_period"])
        for r in cf_during_peak
    } if cf_during_peak is not None else {}

    def col(name: str, missing: float) -> List[float]:
        out = [_num_cell(r.get(name)) for r in state_limits]
        return [missing if np.isnan(v) else v for v in out]

    first = col("first_year", -np.inf)
    sunset = col("sunset_year", np.inf)
    max_mw = col("max_cum_capacity_mw", np.nan)
    max_pct = col("max_pct_cum_capacity", np.nan)

    for row_i, row in enumerate(state_limits):
        s = str(row["state_abbr"])
        if s not in st_idx:
            continue
        si = st_idx[s]
        for yi, y in enumerate(years):
            if not (first[row_i] <= y <= sunset[row_i]):
                continue  # caps don't apply outside the window
            cap = NO_CAP
            if np.isfinite(max_mw[row_i]):
                cap = min(cap, float(max_mw[row_i]) * 1000.0)
            if np.isfinite(max_pct[row_i]) and s in peak and cf.get(s, 0.0) > 0:
                mult = (
                    float(res_load_multiplier[yi, si])
                    if res_load_multiplier is not None else 1.0
                )
                mw = (float(max_pct[row_i]) / 100.0) * peak[s] * mult / cf[s]
                cap = min(cap, mw * 1000.0)
            caps[yi, si] = cap
    return caps


def _records(df) -> Optional[List[Dict[str, object]]]:
    return None if df is None else df.to_dict("records")


def compile_state_nem_caps(
    state_limits,
    peak_demand_mw,
    cf_during_peak,
    years: Sequence[int],
    states: Sequence[str],
    res_load_multiplier: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`compile_state_nem_caps_rows` on DataFrames (the JAX
    package's signature): each frame's records are its rows."""
    if state_limits is None or len(state_limits) == 0:
        return np.full((len(years), len(states)), NO_CAP, dtype=np.float32)
    return compile_state_nem_caps_rows(
        _records(state_limits), _records(peak_demand_mw), _records(cf_during_peak),
        years, states, res_load_multiplier)


def resolve_agent_nem_policy(
    state_by_sector,
    utility_by_sector,
    agent_state: Sequence[str],
    agent_sector: Sequence[str],
    agent_eia_id: Optional[Sequence] = None,
) -> dict:
    """Per-agent NEM attributes after utility-overrides-state resolution.

    Reference semantics (elec.py:92-119 ``apply_export_tariff_params``):
    an agent whose (eia_id, sector, state) matches a utility row takes
    that row's ``nem_system_kw_limit``; otherwise the (state, sector)
    row applies; otherwise the limit is 0 — NO net metering (the
    reference's ``fillna(0)``, elec.py:119). The availability window
    [first_year, sunset_year] rides along from whichever row won
    (reference filter_nem_year, elec.py:449-454, applied per year).

    Returns dict of float32 [N] arrays: ``nem_kw_limit``,
    ``nem_first_year``, ``nem_sunset_year``.
    """
    n = len(agent_state)
    limit = np.zeros(n, dtype=np.float32)
    first = np.zeros(n, dtype=np.float32)
    sunset = np.full(n, 9999.0, dtype=np.float32)

    def norm_id(v) -> str:
        # eia ids arrive as int64 from CSVs but float64 ('1234.0') from
        # NaN-bearing pickle columns; normalize so they match
        try:
            return str(int(float(v)))
        except (TypeError, ValueError):
            return str(v)

    def index_rows(df, keys):
        out = {}
        if df is None or len(df) == 0:
            return out
        lim = _num(df, "nem_system_kw_limit").fillna(0.0)
        fy = _num(df, "first_year").fillna(-np.inf)
        sy = _num(df, "sunset_year").fillna(np.inf)
        for i, row in df.iterrows():
            k = tuple(
                norm_id(row[c]) if c == "eia_id" else str(row[c])
                for c in keys
            )
            # first row wins, matching the reference's drop_duplicates
            # (elec.py:101-102)
            out.setdefault(k, (float(lim[i]), float(fy[i]), float(sy[i])))
        return out

    state_rows = index_rows(state_by_sector, ["state_abbr", "sector_abbr"])
    util_rows = index_rows(
        utility_by_sector, ["eia_id", "sector_abbr", "state_abbr"]
    )

    for i in range(n):
        hit = None
        if agent_eia_id is not None and util_rows:
            hit = util_rows.get(
                (norm_id(agent_eia_id[i]), str(agent_sector[i]),
                 str(agent_state[i]))
            )
        if hit is None:
            hit = state_rows.get((str(agent_state[i]), str(agent_sector[i])))
        if hit is None:
            continue  # limit 0 = no NEM
        lim, fy, sy = hit
        limit[i] = np.float32(min(lim, NO_CAP)) if lim > 0 else 0.0
        first[i] = max(fy, 0.0) if np.isfinite(fy) else 0.0
        sunset[i] = min(sy, 9999.0) if np.isfinite(sy) else 9999.0
    return {
        "nem_kw_limit": limit,
        "nem_first_year": first,
        "nem_sunset_year": sunset,
    }
