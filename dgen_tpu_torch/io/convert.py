"""Convert the reference's agent population into an agent package (port
of ``dgen_tpu/io/convert.py``).

The reference distributes its population as a pandas pickle whose rows
carry object cells — a ``tariff_dict`` per agent, profile keys that
resolve through per-agent Postgres SQL (reference
input_data_functions.py:389 ``import_agent_file``,
agent_mutation/elec.py:508-558) — none of which can live on the card.
This module runs ONCE, offline and on the CPU side (it needs pandas),
and compiles that pickle into the dense package format of
:mod:`dgen_tpu_torch.io.package`:

  * raw/stringified ``tariff_dict`` cells are parsed, deduplicated and
    compiled into a TariffBank spec list
    (semantics: financial_functions.py:655 ``_parse_tariff_dict`` and
    :962 ``normalize_tariff``);
  * known-bad tariff ids are reassigned before compilation (the
    converter-time analogue of agent_mutation/elec.py:868
    ``reassign_agent_tariffs``; bad ids at :993);
  * per-agent profile keys — (bldg_id, sector_abbr, state_abbr) for
    load, (solar_re_9809_gid, tilt, azimuth) for solar CF — are
    resolved against profile tables, deduplicated into shared banks and
    replaced by integer bank indices;
  * the optional state-incentive table is compiled to top-2 fixed-width
    slots per agent (financial_functions.py:1014 ``process_incentives``
    consumes exactly two CBI/PBI/IBI rows).

The package it writes loads through
:func:`dgen_tpu_torch.io.package.load_population` with numpy alone, on
the card. This is not :mod:`dgen_tpu_torch.convert`: that module carries
arrays the JAX package already holds across to the port's containers;
this one compiles the reference's pickle itself.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

import torch

from dgen_tpu_torch.config import SECTORS, resolve_device
from dgen_tpu_torch.io import package
from dgen_tpu_torch.io.reference_inputs import CENSUS_DIVISIONS
from dgen_tpu_torch.models.agents import ProfileBank, build_agent_table
from dgen_tpu_torch.ops.cashflow import IncentiveParams
from dgen_tpu_torch.ops.tariff import (
    BIG_CAP, NET_BILLING, NET_METERING, compile_tariffs,
)

#: tariff ids the reference replaces wholesale (agent_mutation/elec.py:993)
BAD_TARIFF_IDS = (4145, 7111, 8498, 10953, 10954, 12003)

HOURS = 8760


# ---------------------------------------------------------------------------
# tariff_dict parsing + conversion
# ---------------------------------------------------------------------------

def parse_tariff_dict(raw: Any) -> Dict[str, Any]:
    """Coerce a pickle cell into a tariff dict.

    The reference tolerates dicts, JSON-ish strings and Python-literal
    strings with embedded nan/none (financial_functions.py:655
    ``_parse_tariff_dict``); the converter must accept the same inputs
    since pickles in the wild carry all three.
    """
    if isinstance(raw, dict):
        return raw
    if not isinstance(raw, str):
        return {}
    s = raw.replace("'", '"')
    s = re.sub(r"\b(nan|none|null)\b", "null", s, flags=re.IGNORECASE)
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        try:
            out = ast.literal_eval(raw)
            return out if isinstance(out, dict) else {}
        except Exception:
            return {}


def _metering_code(td: Dict[str, Any]) -> int:
    """Reference metering codes 0=NM / 1,2=net-billing-style -> bank codes.

    The reference forces net billing globally (FORCE_NET_BILLING,
    financial_functions.py:37,590); the converter preserves the raw
    option and leaves forcing to the scenario config, which owns that
    policy switch in this framework.
    """
    mo = int(td.get("ur_metering_option", 0) or 0)
    return NET_METERING if mo == 0 else NET_BILLING


def reference_tariff_to_spec(td: Dict[str, Any]) -> Dict[str, Any]:
    """One reference ``tariff_dict`` -> one compiler spec dict.

    Handles both shapes found in agent pickles: the legacy URDB-style
    e_* fields ([T][P] prices/levels + 0-based 12x24 schedules) and the
    already-normalized PySAM fields (``ur_ec_tou_mat`` rows
    [period(1..P), tier(1..T), max_usage, unit, price, sell] with
    1-based 12x24 schedules) — the same two shapes
    financial_functions.py:962 ``normalize_tariff`` accepts. Demand
    charges are excluded from the ENERGY spec, matching the reference's
    global SKIP_DEMAND_CHARGES=True (financial_functions.py:35); they
    are preserved separately by
    :func:`reference_tariff_to_demand_spec` for analysis runs.
    """
    spec: Dict[str, Any] = {
        "fixed_charge": float(
            td.get("ur_monthly_fixed_charge", td.get("fixed_charge", 0.0))
            or 0.0),
        "metering": _metering_code(td),
    }

    ec_tou = td.get("ur_ec_tou_mat")
    if ec_tou:
        rows = np.asarray(ec_tou, dtype=np.float64)
        periods = rows[:, 0].astype(int)
        tiers = rows[:, 1].astype(int)
        P, T = int(periods.max()), int(tiers.max())
        price = np.zeros((P, T))
        caps = np.full(T, BIG_CAP)
        for r in rows:
            p, t = int(r[0]) - 1, int(r[1]) - 1
            price[p, t] = r[4]
            caps[t] = min(caps[t], r[2]) if r[2] > 0 else caps[t]
        spec["price"] = price.tolist()
        spec["tier_cap"] = caps.tolist()
        # ur schedules are 1-based; the compiler wants 0-based
        for src, dst in (("ur_ec_sched_weekday", "e_wkday_12by24"),
                         ("ur_ec_sched_weekend", "e_wkend_12by24")):
            sched = td.get(src)
            if sched is not None:
                spec[dst] = (np.asarray(sched, dtype=np.int64) - 1).clip(
                    0).tolist()
        return spec

    for key in ("e_prices", "e_levels", "e_wkday_12by24", "e_wkend_12by24"):
        if td.get(key) is not None:
            spec[key] = td[key]
    if "e_prices" not in spec:
        # degenerate/empty dict -> inert flat tariff so compilation
        # never fails on a malformed cell (the reference's parser
        # likewise degrades to {} and PySAM defaults)
        spec["price"] = [[0.1]]
    return spec


def reference_tariff_to_demand_spec(
    td: Dict[str, Any],
) -> Optional[Dict[str, Any]]:
    """Demand-charge fields of one ``tariff_dict`` -> a JSON-able demand
    spec, or None when the tariff has no demand charges.

    The hot loop drops these on purpose (SKIP_DEMAND_CHARGES parity,
    financial_functions.py:35); this hook preserves them for analysis
    runs through :mod:`dgen_tpu.ops.demand`. Both shapes found in agent
    pickles are accepted — legacy ``d_flat_*`` [T][12] / ``d_tou_*``
    [T][P] arrays with 0-based ``d_wkday_12by24`` schedules (the URDB
    repackaging of tariff_functions.py:213-268) and PySAM
    ``ur_dc_flat_mat`` / ``ur_dc_tou_mat`` rows
    [period(1..P), tier(1..T), max_kW, price] with 1-based schedules
    (financial_functions.py:793 ``_build_ur_dc_from_d_parts``).

    Spec keys mirror :func:`dgen_tpu.ops.demand.compile_demand_tariff`
    kwargs plus the two 12x24 window schedules (expanded to the hourly
    map at bank-compile time).
    """
    def dense_from_mat(mat):
        rows = np.asarray(mat, dtype=np.float64)
        if rows.ndim != 2 or rows.shape[1] < 4 or not rows.size:
            return None, None
        # junk guard: every row's period/tier index must be a sane
        # 1-based URDB index — a malformed row (e.g. a max_kW landed in
        # the tier column, or a 0/negative index that would wrap the
        # dense fill below) makes the tariff's demand charges
        # unpriceable rather than silently mis-binned
        pcol, tcol = rows[:, 0], rows[:, 1]
        if not (
            np.all((1 <= pcol) & (pcol <= 64) & (pcol == np.floor(pcol)))
            and np.all((1 <= tcol) & (tcol <= 64) & (tcol == np.floor(tcol)))
        ):
            return None, None
        P = int(pcol.max())
        T = int(tcol.max())
        prices = np.zeros((T, P))
        levels = np.full((T, P), BIG_CAP)
        for r in rows:
            p, t = int(r[0]) - 1, int(r[1]) - 1
            prices[t, p] = r[3]
            if r[2] > 0:
                levels[t, p] = min(levels[t, p], r[2])
        return prices, levels

    def pick(prices_key, levels_key, mat_key):
        pr, lv = td.get(prices_key), td.get(levels_key)
        if pr is not None and np.asarray(pr, np.float64).size:
            pr = np.asarray(pr, np.float64)
            lv = (np.asarray(lv, np.float64) if lv is not None
                  else np.full(pr.shape, BIG_CAP))
        elif td.get(mat_key):
            pr, lv = dense_from_mat(td[mat_key])
        else:
            return None, None
        if pr is None or not np.any(pr > 0):
            return None, None
        return pr.tolist(), lv.tolist()

    out: Dict[str, Any] = {}
    fp, fl = pick("d_flat_prices", "d_flat_levels", "ur_dc_flat_mat")
    if fp is not None:
        out["d_flat_prices"], out["d_flat_levels"] = fp, fl
    tp, tl = pick("d_tou_prices", "d_tou_levels", "ur_dc_tou_mat")
    if tp is not None:
        out["d_tou_prices"], out["d_tou_levels"] = tp, tl
    if not out:
        return None

    if "d_tou_prices" in out:
        wkday = td.get("d_wkday_12by24")
        wkend = td.get("d_wkend_12by24")
        if wkday is None and td.get("ur_dc_sched_weekday") is not None:
            # ur schedules are 1-based (financial_functions.py:823)
            wkday = (np.asarray(td["ur_dc_sched_weekday"], np.int64)
                     - 1).clip(0).tolist()
            # key may be present-but-None (parse_tariff_dict rewrites
            # nan/none to JSON null), so .get's default is not enough
            raw_we = td.get("ur_dc_sched_weekend")
            if raw_we is None:
                raw_we = td["ur_dc_sched_weekday"]
            wkend = (np.asarray(raw_we, np.int64) - 1).clip(0).tolist()
        if wkday is not None:
            out["d_wkday_12by24"] = np.asarray(wkday, np.int64).tolist()
            out["d_wkend_12by24"] = np.asarray(
                wkend if wkend is not None else wkday, np.int64).tolist()
    return out


def _canonical_key(spec: Dict[str, Any]) -> str:
    return json.dumps(spec, sort_keys=True)


# ---------------------------------------------------------------------------
# bad-tariff reassignment
# ---------------------------------------------------------------------------

def reassign_bad_tariffs(
    df: pd.DataFrame,
    bad_ids: Sequence[int] = BAD_TARIFF_IDS,
) -> pd.DataFrame:
    """Replace known-bad tariffs before compilation.

    The reference swaps six corrupt URDB ids for hardcoded per-state
    defaults pulled from its Postgres tariff store
    (agent_mutation/elec.py:868-988). Without that store, the converter
    reassigns each bad-tariff agent to the modal good tariff of its
    (state_abbr, sector_abbr) cell, falling back to the sector's modal
    tariff, then to any good tariff — preserving the invariant the
    reference cares about (no agent sizes against a corrupt rate) with
    a data-driven default.
    """
    bad = df["tariff_id"].isin(list(bad_ids))
    if not bad.any():
        return df
    good = df[~bad]
    if good.empty:
        raise ValueError("every agent has a bad tariff id; cannot reassign")

    df = df.copy()

    # vectorized modal lookup: one groupby per fallback level instead of
    # a per-bad-row scan (national pickles carry ~1e6 rows)
    first_mode = lambda s: s.mode().iloc[0]
    modal_ss = good.groupby(["state_abbr", "sector_abbr"])["tariff_id"] \
        .agg(first_mode)
    modal_s = good.groupby("sector_abbr")["tariff_id"].agg(first_mode)
    modal_any = first_mode(good["tariff_id"])
    # representative dict per good tariff id (ids key a shared tariff
    # table in the reference, so same-id rows carry the same dict)
    rep = good.drop_duplicates("tariff_id").set_index("tariff_id")[
        "tariff_dict"]

    bad_rows = df.loc[bad]
    key = pd.MultiIndex.from_frame(bad_rows[["state_abbr", "sector_abbr"]])
    tid = modal_ss.reindex(key).to_numpy(object)
    fb = modal_s.reindex(bad_rows["sector_abbr"]).to_numpy(object)
    tid = np.where(pd.isna(tid), fb, tid)
    tid = np.where(pd.isna(tid), modal_any, tid)
    df.loc[bad, "tariff_id"] = pd.array(
        tid, dtype=df["tariff_id"].dtype)
    df.loc[bad, "tariff_dict"] = rep.reindex(tid).to_numpy(object)
    return df


# ---------------------------------------------------------------------------
# profile resolution
# ---------------------------------------------------------------------------

def _as_frame(src: Union[str, pd.DataFrame]) -> pd.DataFrame:
    if isinstance(src, pd.DataFrame):
        return src
    if str(src).endswith(".parquet"):
        return pd.read_parquet(src)
    return pd.read_pickle(src)


def _profile_bank(
    df: pd.DataFrame,
    key_cols: Sequence[str],
    value_col: str,
    used_keys: Sequence[Tuple],
    scale: float = 1.0,
    normalize_sum: bool = False,
) -> Tuple[np.ndarray, Dict[Tuple, int]]:
    """Dedup profiles by key into an [n, 8760] bank + key->row map.

    O(rows) dict build from plain tuples — no per-row pandas Series
    (iterrows at national scale was the converter's wall-clock sink).
    """
    lut: Dict[Tuple, int] = {}
    # restrict to the USED keys before touching the value column: each
    # cell is an 8760-element object, and materializing the whole column
    # (a national table carries ~1e5 distinct profiles) costs GBs of
    # Python lists at peak — the key->position map is ints only, and
    # only referenced rows are ever converted (last occurrence wins,
    # matching the former dict(zip(...)) semantics)
    need = set(used_keys)
    row_pos: Dict[Tuple, int] = {}
    for i, k in enumerate(
        df[list(key_cols)].itertuples(index=False, name=None)
    ):
        if k in need:
            row_pos[k] = i
    values = df[value_col]
    rows = []
    for k in used_keys:
        if k in lut:
            continue
        if k not in row_pos:
            raise KeyError(f"profile key {k!r} not found in profile table "
                           f"(keys {list(key_cols)})")
        arr = np.asarray(values.iloc[row_pos[k]], dtype=np.float64).ravel()
        if arr.size != HOURS:
            raise ValueError(f"profile {k!r} has {arr.size} hours != {HOURS}")
        arr = arr * scale
        if normalize_sum:
            s = arr.sum()
            arr = arr / s if s > 0 else np.full(HOURS, 1.0 / HOURS)
        lut[k] = len(rows)
        rows.append(arr.astype(np.float32))
    return np.stack(rows), lut


# ---------------------------------------------------------------------------
# incentives
# ---------------------------------------------------------------------------

def compile_incentives(
    state_incentives: Optional[pd.DataFrame],
    state_abbr: pd.Series,
    sector_abbr: pd.Series,
) -> Optional[IncentiveParams]:
    """Reference state-incentive rows -> top-2 per-agent slots.

    Row schema follows the reference table consumed by
    agent_mutation/elec.py:656 ``apply_state_incentives`` /
    financial_functions.py:1014 ``process_incentives``: state_abbr,
    sector_abbr, cbi_usd_p_w, ibi_pct, pbi_usd_p_kwh,
    max_incentive_usd, incentive_duration_yrs. The reference fills
    missing duration/max with 5 yrs / $10k (:1025).
    """
    if state_incentives is None or state_incentives.empty:
        return None
    si = state_incentives.fillna(
        value={"incentive_duration_yrs": 5.0, "max_incentive_usd": 10000.0})

    # compile top-2 slots once per (state, sector) CELL — at most
    # n_states x 3 of them — then gather per agent, instead of walking
    # the agent axis in Python (the national pickle has ~1e6 rows)
    cells: Dict[Tuple, Dict[str, np.ndarray]] = {}
    for (st, sec), g in si.groupby(["state_abbr", "sector_abbr"]):
        c = {k: np.zeros(2, np.float32)
             for k in ("cbi_usd_p_w", "cbi_max_usd", "ibi_frac",
                       "ibi_max_usd", "pbi_usd_p_kwh")}
        c["pbi_years"] = np.zeros(2, np.int32)
        cbi = g[g.get("cbi_usd_p_w", pd.Series(dtype=float)).notna()] \
            .sort_values("cbi_usd_p_w", ascending=False)
        for s, (_, row) in enumerate(cbi.head(2).iterrows()):
            c["cbi_usd_p_w"][s] = row["cbi_usd_p_w"]
            c["cbi_max_usd"][s] = row["max_incentive_usd"]
        if "ibi_pct" in g:
            ibi = g[g["ibi_pct"].notna()].sort_values(
                "ibi_pct", ascending=False)
            for s, (_, row) in enumerate(ibi.head(2).iterrows()):
                c["ibi_frac"][s] = row["ibi_pct"]
                c["ibi_max_usd"][s] = row["max_incentive_usd"]
        if "pbi_usd_p_kwh" in g:
            pbi = g[g["pbi_usd_p_kwh"].notna()].sort_values(
                "pbi_usd_p_kwh", ascending=False)
            for s, (_, row) in enumerate(pbi.head(2).iterrows()):
                c["pbi_usd_p_kwh"][s] = row["pbi_usd_p_kwh"]
                c["pbi_years"][s] = int(row["incentive_duration_yrs"])
        cells[(st, sec)] = c

    n = len(state_abbr)
    if not cells:
        # rows exist but none form a (state, sector) group (NaN keys are
        # dropped by groupby) — same all-zero result as no matches
        zero = {k: np.zeros((n, 2), np.float32)
                for k in ("cbi_usd_p_w", "cbi_max_usd", "ibi_frac",
                          "ibi_max_usd", "pbi_usd_p_kwh")}
        return _incentive_params(pbi_years=np.zeros((n, 2), np.int32), **zero)

    keys = list(cells)
    cell_idx = {k: i for i, k in enumerate(keys)}
    # stacked [n_cells + 1, 2] tables; the last row is the all-zero
    # no-incentive cell agents without a matching row gather from
    def stacked(name, dtype):
        z = np.zeros((1, 2), dtype)
        return np.concatenate(
            [np.stack([cells[k][name] for k in keys]).astype(dtype), z])

    agent_cell = np.asarray([
        cell_idx.get((st, sec), len(keys))
        for st, sec in zip(state_abbr, sector_abbr)
    ])
    out = {k: stacked(k, np.float32)[agent_cell]
           for k in ("cbi_usd_p_w", "cbi_max_usd", "ibi_frac",
                     "ibi_max_usd", "pbi_usd_p_kwh")}
    return _incentive_params(
        pbi_years=stacked("pbi_years", np.int32)[agent_cell], **out)


def _incentive_params(**leaves: np.ndarray) -> IncentiveParams:
    """[n, 2] host leaves -> IncentiveParams of CPU tensors; flat PBI
    rates (pbi_decay 0), as the reference's hot path pays them."""
    leaves["pbi_decay"] = np.zeros_like(leaves["pbi_usd_p_kwh"])
    return IncentiveParams(**{k: torch.from_numpy(v) for k, v in leaves.items()})


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def _col(df: pd.DataFrame, name: str, default=None):
    """Column with the reference's ``*_initial`` fallback convention
    (apply_load_growth rewrites the non-initial columns every year,
    elec.py:396-406, so pickles may carry either)."""
    if name in df.columns:
        return df[name]
    if f"{name}_initial" in df.columns:
        return df[f"{name}_initial"]
    if default is not None:
        return pd.Series(np.full(len(df), default), index=df.index)
    raise KeyError(f"agent frame missing required column {name!r}")


def _developable_frac(df: pd.DataFrame) -> np.ndarray:
    """Developable fraction per agent.

    This fork weights by raw customers (elec.py:418
    ``developable_agent_weight = customers_in_bin`` -> frac 1.0); older
    pickles carry ``pct_of_bldgs_developable`` on a 0-100 scale, which
    is detected and rescaled.
    """
    if "pct_of_bldgs_developable" not in df.columns:
        return np.ones(len(df), np.float32)
    v = df["pct_of_bldgs_developable"].to_numpy(np.float32)
    if np.nanmax(v, initial=0.0) > 1.0:
        v = v / 100.0
    return np.clip(np.nan_to_num(v, nan=1.0), 0.0, 1.0)


def from_reference_pickle(
    agents: Union[str, pd.DataFrame],
    out_dir: str,
    load_profiles: Union[str, pd.DataFrame],
    solar_profiles: Union[str, pd.DataFrame],
    wholesale_by_region: Optional[Dict[str, np.ndarray]] = None,
    state_incentives: Optional[pd.DataFrame] = None,
    states: Optional[Sequence[str]] = None,
    bad_tariff_ids: Sequence[int] = BAD_TARIFF_IDS,
    nem_state_by_sector: Optional[pd.DataFrame] = None,
    nem_utility_by_sector: Optional[pd.DataFrame] = None,
    device="cuda",
) -> package.Population:
    """Compile a reference-format agent pickle into a package at
    ``out_dir`` and return the :class:`Population` on ``device``.

    Parameters mirror what the reference pipeline resolves at load
    time: ``load_profiles`` replaces the per-agent SQL of
    elec.py:508 (columns bldg_id/sector_abbr/state_abbr +
    ``consumption_hourly``), ``solar_profiles`` replaces elec.py:535
    (solar_re_9809_gid/tilt/azimuth + ``cf`` at the reference's 1e6
    scale offset), ``wholesale_by_region`` maps census division -> an
    [8760] $/kWh sell-rate profile (flat arrays accepted).
    """
    dev = resolve_device(device)
    df = _as_frame(agents)
    if df.index.name == "agent_id":
        df = df.reset_index()

    required = ("state_abbr", "sector_abbr", "tariff_id", "tariff_dict",
                "bldg_id", "solar_re_9809_gid", "tilt", "azimuth")
    missing = [c for c in required if c not in df.columns]
    if missing:
        raise ValueError(f"agent frame missing columns: {missing}")

    if states:
        df = df[df["state_abbr"].isin(list(states))].reset_index(drop=True)
        if df.empty:
            raise ValueError("state filter removed every agent "
                             "(reference input_data_functions.py:436)")
    df = reassign_bad_tariffs(df, bad_tariff_ids)

    state_list = sorted(df["state_abbr"].unique()) if states is None \
        else list(states)
    st_idx = {s: i for i, s in enumerate(state_list)}
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    cd_idx = {c: i for i, c in enumerate(CENSUS_DIVISIONS)}

    # --- tariffs: parse, convert, dedup ---
    # parse once per UNIQUE tariff_id, not per agent: ids key a shared
    # tariff table in the reference (reassign_agent_tariffs swaps by id,
    # elec.py:868), so same-id rows carry the same dict; a national
    # pickle has ~1e6 agents over a few thousand tariffs
    specs: List[Dict[str, Any]] = []
    spec_lut: Dict[str, int] = {}
    tids = df["tariff_id"].to_numpy()
    uniq_tids, first_pos, inv = np.unique(
        tids, return_index=True, return_inverse=True)
    spec_of_uid = np.zeros(len(uniq_tids), np.int32)
    raw_dicts = df["tariff_dict"].to_numpy(object)
    for u, pos in enumerate(first_pos):
        td = parse_tariff_dict(raw_dicts[pos])
        spec = reference_tariff_to_spec(td)
        # demand charges ride along as a sub-spec: inert for the hot
        # loop (normalize_tariff_spec ignores the key; SKIP_DEMAND_
        # CHARGES parity) but compiled on demand for analysis runs via
        # ops.demand.compile_demand_bank
        dspec = reference_tariff_to_demand_spec(td)
        if dspec is not None:
            spec["demand"] = dspec
        key = _canonical_key(spec)
        if key not in spec_lut:
            spec_lut[key] = len(specs)
            specs.append(spec)
        spec_of_uid[u] = spec_lut[key]
    tariff_idx = spec_of_uid[inv].astype(np.int32)

    # --- profiles: dedup into banks ---
    load_keys = [tuple(r) for r in
                 df[["bldg_id", "sector_abbr", "state_abbr"]].itertuples(
                     index=False)]
    load_bank, load_lut = _profile_bank(
        _as_frame(load_profiles),
        ("bldg_id", "sector_abbr", "state_abbr"), "consumption_hourly",
        load_keys, normalize_sum=True)
    load_idx = np.asarray([load_lut[k] for k in load_keys], np.int32)

    cf_keys = [tuple(r) for r in
               df[["solar_re_9809_gid", "tilt", "azimuth"]].itertuples(
                   index=False)]
    # reference stores CF at a 1e6 scale offset (elec.py:546-551,
    # financial_functions.py:350 divides by 1e-6-implied offset)
    cf_bank, cf_lut = _profile_bank(
        _as_frame(solar_profiles),
        ("solar_re_9809_gid", "tilt", "azimuth"), "cf",
        cf_keys, scale=1e-6)
    cf_idx = np.asarray([cf_lut[k] for k in cf_keys], np.int32)

    # --- regions + wholesale sell-rate bank ---
    if "census_division_abbr" in df.columns:
        region_idx = np.asarray(
            [cd_idx.get(c, 0) for c in df["census_division_abbr"]], np.int32)
        region_names = list(CENSUS_DIVISIONS)
    else:
        region_idx = np.zeros(len(df), np.int32)
        region_names = ["ALL"]
    wholesale = np.zeros((len(region_names), HOURS), np.float32)
    if wholesale_by_region:
        for r, name in enumerate(region_names):
            prof = wholesale_by_region.get(name)
            if prof is None:
                continue
            arr = np.asarray(prof, dtype=np.float32).ravel()
            wholesale[r] = arr if arr.size == HOURS else np.full(
                HOURS, float(arr.mean()), np.float32)

    incentives = compile_incentives(
        state_incentives, df["state_abbr"], df["sector_abbr"])

    # --- per-agent NEM policy (utility overrides state, elec.py:92-119);
    # without tables, keep the unlimited-NEM defaults ---
    nem_fields: Dict[str, np.ndarray] = {}
    if nem_state_by_sector is not None or nem_utility_by_sector is not None:
        from dgen_tpu_torch.io.nem import resolve_agent_nem_policy

        eia = df["eia_id"].astype(str).tolist() if "eia_id" in df.columns \
            else None
        nem_fields = resolve_agent_nem_policy(
            nem_state_by_sector, nem_utility_by_sector,
            agent_state=df["state_abbr"].tolist(),
            agent_sector=df["sector_abbr"].tolist(),
            agent_eia_id=eia,
        )

    table = build_agent_table(
        state_idx=np.asarray([st_idx[s] for s in df["state_abbr"]], np.int32),
        sector_idx=np.asarray([sec_idx[s] for s in df["sector_abbr"]],
                              np.int32),
        region_idx=region_idx,
        tariff_idx=tariff_idx,
        load_idx=load_idx,
        cf_idx=cf_idx,
        customers_in_bin=_col(df, "customers_in_bin").to_numpy(np.float32),
        load_kwh_per_customer_in_bin=_col(
            df, "load_kwh_per_customer_in_bin").to_numpy(np.float32),
        developable_frac=_developable_frac(df),
        n_states=len(state_list),
        incentives=None if incentives is None else {
            k: v.numpy() for k, v in vars(incentives).items()},
        device=dev,
        **nem_fields,
    )

    profiles = ProfileBank(load=torch.from_numpy(load_bank).to(dev),
                           solar_cf=torch.from_numpy(cf_bank).to(dev),
                           wholesale=torch.from_numpy(wholesale).to(dev))
    package.save_population(out_dir, table, profiles, specs, state_list)
    return package.Population(
        table=table, profiles=profiles,
        tariffs=compile_tariffs(specs, device=dev),
        states=state_list, tariff_specs=specs,
    )
