"""Build a full :class:`ScenarioInputs` from a reference-format
``input_data/`` directory (port of ``dgen_tpu/io/reference_inputs.py``).

The replacement for the reference's Excel-workbook -> Postgres ->
13-pandas-merges input pipeline: every trajectory CSV the reference
ships is parsed straight to dense host arrays on the model-year grid by
``io.ingest``, and this module assembles them into one scenario on the
device. Every field is computed in numpy, in the JAX package's dtypes
and order of operations (float32 BA means, float32 shape normalisation,
the float64 attachment average and ``np.interp`` grid), so the inputs
are bit for bit the JAX package's; tensors are made only in
``uniform_inputs(..., device=)``. Nothing here imports pandas: the NEM
caps compile from the rows ``io.ingest._read_csv`` returns
(``io.nem.compile_state_nem_caps_rows``), so the ingest runs on a
machine without pandas.

Sourced per reference table (reference file -> field):
  * pv_prices/*                -> pv_capex_per_kw, pv_om_per_kw
  * pv_tech_performance/*      -> pv_degradation
  * batt_prices/*              -> batt_capex_per_kwh / _per_kw
  * pv_plus_batt_prices/*      -> *_combined fields
  * financing_terms/*          -> FinanceParams trajectories
  * load_growth/*              -> load_growth [Y, R, S]
  * elec_prices/*              -> elec_price_multiplier + escalator
  * wholesale_electricity_prices/* -> flat hourly sell-rate base [R]
  * batt_tech_performance/*    -> batt_eff, batt_lifetime_yrs
  * depreciation_schedules/*   -> deprec_sch [Y, S, D]
  * carbon_intensities/*       -> carbon_intensity_t_per_kwh [Y, states]
  * installed_capacity_mw_by_state_sector.csv -> starting_kw [G]
  * observed_deployment_by_state_sector_*.csv -> observed_kw [Y, G]
  * ohm_attachment_rates.csv   -> attachment_rate [G]
  * peak_demand_mw.csv + cf_during_peak_demand.csv (+ exported
    nem_state_limits.csv)      -> nem_cap_kw [Y, states]
  * itc_schedule.csv (optional) -> itc_fraction (else federal statute)
  * value_of_resiliency/*      -> value_of_resiliency [Y, G]
  * max_market_curves.csv (optional drop-in) -> mms_table
  * bass_params.csv (optional drop-in)       -> bass_p/q, teq_yr1

Bass p/q/teq and the max-market-share curves live only in the
reference's Postgres dump, not its input_data CSVs; they are accepted
here as exported drop-ins (``max_market_curves.csv`` /
``bass_params.csv``, schemas mirroring data_functions.py:279,370).
Absent those, the synthetic :func:`uniform_inputs` defaults remain and
``meta["market_curves"]`` says so. ITC fraction likewise comes from the
scenario workbook; the default schedule here mirrors the federal
statute (see ``itc_schedule.csv``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dgen_tpu_torch.config import SECTORS, ScenarioConfig
from dgen_tpu_torch.io import ingest
from dgen_tpu_torch.io.ingest import _read_csv
from dgen_tpu_torch.io.nem import compile_state_nem_caps_rows
from dgen_tpu_torch.models import scenario as scen
from dgen_tpu_torch.models.scenario import ScenarioInputs
from dgen_tpu_torch.utils.timing import fn_timer

logger = logging.getLogger(__name__)

#: census divisions (the reference's load-growth region key)
CENSUS_DIVISIONS = ("NE", "MA", "ENC", "WNC", "SA", "ESC", "WSC", "MTN", "PAC")

#: standard US Census Bureau state -> division assignment (the
#: reference resolves this via its county table's
#: census_division_abbr column, absent from the OS release; a state's
#: counties all share its division, so the division IS the per-state
#: key). Division abbrs match CENSUS_DIVISIONS; note division "NE"
#: (New England) vs state "NE" (Nebraska) are distinct namespaces.
STATE_CENSUS_DIVISION = {
    **{s: "NE" for s in ("CT", "MA", "ME", "NH", "RI", "VT")},
    **{s: "MA" for s in ("NJ", "NY", "PA")},
    **{s: "ENC" for s in ("IL", "IN", "MI", "OH", "WI")},
    **{s: "WNC" for s in ("IA", "KS", "MN", "MO", "ND", "NE", "SD")},
    **{s: "SA" for s in ("DC", "DE", "FL", "GA", "MD", "NC", "SC",
                         "VA", "WV")},
    **{s: "ESC" for s in ("AL", "KY", "MS", "TN")},
    **{s: "WSC" for s in ("AR", "LA", "OK", "TX")},
    **{s: "MTN" for s in ("AZ", "CO", "ID", "MT", "NM", "NV", "UT",
                          "WY")},
    **{s: "PAC" for s in ("AK", "CA", "HI", "OR", "WA")},
}


def load_pv_plus_batt_prices(
    path: str, model_years: Sequence[int]
) -> Dict[str, np.ndarray]:
    """pv_plus_batt_prices CSV -> combined-system cost trajectories
    [Y, 3] (res/nonres columns duplicated to com+ind, the reference's
    stacked_sectors shaper convention)."""
    out = {}
    for field, key in (
        ("system_capex_per_kw", "pv_capex_per_kw_combined"),
        ("batt_capex_per_kwh", "batt_capex_per_kwh_combined"),
    ):
        out[key] = ingest.load_stacked_sectors(
            path, field, model_years, nonres_suffix=True
        )
    return out


def load_starting_capacities(
    path: str, start_year: int, states: Sequence[str]
) -> np.ndarray:
    """installed_capacity_mw_by_state_sector.csv -> starting PV kW [G]
    at the scenario start year (reference
    agent_mutation/elec.py:621 ``get_state_starting_capacities``)."""
    rows = _read_csv(path)
    st_idx = {s: i for i, s in enumerate(states)}
    sec_idx = {s: i for i, s in enumerate(SECTORS)}
    g = len(states) * len(SECTORS)
    # use the closest year at or before start_year present in the file
    years = sorted({int(float(r["year"])) for r in rows})
    usable = [y for y in years if y <= start_year] or years[:1]
    pick = usable[-1]
    out = np.zeros(g, dtype=np.float32)
    for r in rows:
        if int(float(r["year"])) != pick:
            continue
        st, sec = r.get("state_abbr", ""), r.get("sector_abbr", "")
        if st in st_idx and sec in sec_idx:
            gi = st_idx[st] * len(SECTORS) + sec_idx[sec]
            out[gi] = float(r["observed_capacity_mw"]) * 1000.0
    return out


def load_wholesale(
    path: str, model_years: Sequence[int], base_year: int
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(ba names, base $/kWh [n_bas], multiplier [Y, n_bas]) from one
    parse of the wholesale CSV (ba, <year columns>).

    The reference feeds annual wholesale prices as the net-billing sell
    rate, re-merged every model year (financial_functions.py:182,372;
    apply_wholesale_elec_prices elec.py:608). Here the base-year level
    seeds the profile bank and the multiplier (1.0 at base) rescales it
    per model year.
    """
    rows = _read_csv(path)
    bas: List[str] = []
    base_vals = np.zeros(len(rows), np.float32)
    mult = np.ones((len(model_years), len(rows)), np.float32)
    for bi, r in enumerate(rows):
        bas.append(r["ba"])
        years = sorted(int(c) for c in r.keys() if c.isdigit())
        pick = max([y for y in years if y <= base_year] or years[:1])
        base = float(r[str(pick)])
        base_vals[bi] = base
        if base <= 0:
            continue
        years_avail = np.asarray(years)
        vals = np.asarray([float(r[str(y)]) for y in years], np.float32)
        traj = ingest._year_grid_interp(years_avail, vals, model_years)
        mult[:, bi] = traj / base
    return bas, base_vals, mult


def load_wholesale_base(
    path: str, base_year: int
) -> Tuple[List[str], np.ndarray]:
    """(ba names, base-year $/kWh) — see :func:`load_wholesale`."""
    bas, base_vals, _ = load_wholesale(path, [base_year], base_year)
    return bas, base_vals


def wholesale_profile_bank(
    meta: Dict[str, object],
    input_root: Optional[str] = None,
) -> np.ndarray:
    """[R, 8760] $/kWh wholesale sell-rate bank from a scenario's meta.

    The reference feeds a FLAT annual wholesale price as the
    net-billing sell rate (one scalar per agent-year,
    financial_functions.py:182,372) — so the flat default here is
    reference-faithful, not a simplification. When the input root
    carries a ``wholesale_hourly_shape.csv`` (column ``shape``, 8760
    rows, or one column per region name), the flat base is modulated by
    that normalized hourly shape instead, giving the TS-sell bill path
    real intra-day/seasonal structure the reference cannot express.
    """
    base = np.asarray(meta["wholesale_base_usd_per_kwh"], dtype=np.float32)
    r = len(base)
    out = np.broadcast_to(base[:, None], (r, 8760)).copy()

    if input_root:
        path = os.path.join(input_root, "wholesale_hourly_shape.csv")
        if os.path.exists(path):
            rows = _read_csv(path)
            if len(rows) != 8760:
                raise ValueError(
                    f"wholesale_hourly_shape.csv has {len(rows)} rows, "
                    "expected 8760"
                )
            regions = list(meta.get("regions", []))
            cols = rows[0].keys()
            for ri, name in enumerate(regions):
                col = name if name in cols else (
                    "shape" if "shape" in cols else None)
                if col is None:
                    continue
                shape = np.asarray([float(r_[col]) for r_ in rows],
                                   dtype=np.float32)
                shape /= max(float(shape.mean()), 1e-9)
                out[ri] = base[ri] * shape
    return out


@fn_timer()
def scenario_inputs_from_reference(
    input_root: str,
    config: ScenarioConfig,
    states: Sequence[str],
    region_kind: str = "census_division",
    overrides: Optional[Dict[str, object]] = None,
    prefer: Optional[Dict[str, str]] = None,
    device="cuda",
) -> Tuple[ScenarioInputs, Dict[str, object]]:
    """(ScenarioInputs, meta) from a reference input_data directory.

    ``region_kind`` picks what the agent ``region_idx`` axis means:
      * "census_division" (9 regions): load growth is regional
        (reference resolution); retail-price trajectories are averaged
        over ReEDS BAs onto every region.
      * "ba": retail prices are per ReEDS BA (reference resolution);
        load growth is the national mean.

    ``meta`` carries the region list and the per-region flat wholesale
    sell rate base [R] ($/kWh) for ProfileBank construction.

    ``prefer`` maps family keys to filename substrings (the scenario
    workbook's per-family trajectory selections, io.workbook /
    ingest.discover_reference_inputs); unmatched preferences fall back
    to the built-in defaults. ``overrides`` (host arrays or tensors) win
    over every ingested field. The inputs are placed on ``device`` (the
    card by default).
    """
    prefer = prefer or {}
    files = ingest.discover_reference_inputs(input_root, prefer=prefer)
    years = list(config.model_years)
    n_states = len(states)
    g = n_states * len(SECTORS)

    def _pick_csv(dirname: str, key: str, default_substr: str) -> Optional[str]:
        d = os.path.join(input_root, dirname)
        if not os.path.isdir(d):
            return None
        cands = sorted(f for f in os.listdir(d) if f.endswith(".csv"))
        if not cands:
            return None
        for substr in (prefer.get(key), default_substr):
            if substr:
                hit = [c for c in cands if substr.lower() in c.lower()]
                if hit:
                    return os.path.join(d, hit[-1])
        return os.path.join(d, cands[-1])

    wholesale_path = _pick_csv(
        "wholesale_electricity_prices", "wholesale", "Mid_Case")

    bas: List[str] = []
    wholesale_base = np.zeros(0, np.float32)
    wholesale_traj = None
    if wholesale_path:
        bas, wholesale_base, wholesale_traj = load_wholesale(
            wholesale_path, years, config.start_year)

    if region_kind == "census_division":
        regions = list(CENSUS_DIVISIONS)
    elif region_kind == "ba":
        regions = bas or list(CENSUS_DIVISIONS)
    else:
        raise ValueError(f"unknown region_kind {region_kind!r}")
    n_regions = len(regions)

    ov: Dict[str, object] = {}

    # --- cost / tech trajectories ---
    if "pv_prices" in files:
        ov["pv_capex_per_kw"] = ingest.load_stacked_sectors(
            files["pv_prices"], "system_capex_per_kw", years)
        ov["pv_om_per_kw"] = ingest.load_stacked_sectors(
            files["pv_prices"], "system_om_per_kw", years)
    if "pv_tech" in files:
        ov["pv_degradation"] = ingest.load_stacked_sectors(
            files["pv_tech"], "pv_degradation_factor", years)
    if "batt_tech" in files:
        bt = ingest.load_batt_tech(files["batt_tech"], years)
        ov["batt_eff"] = bt["batt_eff"]
        ov["batt_lifetime_yrs"] = bt["batt_lifetime_yrs"]
    if "deprec" in files:
        ov["deprec_sch"] = ingest.load_depreciation_schedules(files["deprec"], years)
    if "batt_prices" in files:
        ov["batt_capex_per_kwh"] = ingest.load_stacked_sectors(
            files["batt_prices"], "batt_capex_per_kwh", years,
            nonres_suffix=True)
        ov["batt_capex_per_kw"] = ingest.load_stacked_sectors(
            files["batt_prices"], "batt_capex_per_kw", years,
            nonres_suffix=True)
    pb_path = _pick_csv("pv_plus_batt_prices", "pv_plus_batt", "mid")
    if pb_path:
        pb = load_pv_plus_batt_prices(pb_path, years)
        ov["pv_capex_per_kw_combined"] = pb["pv_capex_per_kw_combined"]
        ov["batt_capex_per_kwh_combined"] = pb["batt_capex_per_kwh_combined"]

    # --- wholesale trajectory -> per-year sell-rate multiplier ---
    if wholesale_traj is not None and len(bas):
        if region_kind == "ba":
            ov["wholesale_multiplier"] = wholesale_traj
        else:
            ov["wholesale_multiplier"] = np.broadcast_to(
                wholesale_traj.mean(axis=1, keepdims=True),
                (len(years), n_regions)).copy()

    # --- carbon intensities (elec.py:595 passthrough) ---
    c_path = _pick_csv("carbon_intensities", "carbon", "")
    if c_path:
        ov["carbon_intensity_t_per_kwh"] = ingest.load_carbon_intensities(
            c_path, years, states)

    # --- ITC schedule: an itc_schedule.csv in the input root (columns
    # itc_fraction_res/com/ind by year — the workbook's itc_options
    # analogue, reference elec.py:348) wins; otherwise the statutory
    # federal schedule ---
    itc_path = os.path.join(input_root, "itc_schedule.csv")
    if os.path.exists(itc_path):
        ov["itc_fraction"] = ingest.load_stacked_sectors(
            itc_path, "itc_fraction", years)
        itc_source = "ingested"
    else:
        ov["itc_fraction"] = scen.federal_itc_schedule(years)
        itc_source = "federal_statute_default"

    # --- financing ---
    if "financing" in files:
        fin = ingest.load_financing_terms(files["financing"], years)
        ov["loan_term_yrs"] = fin["loan_term_yrs"].astype(np.int32)
        ov["loan_interest_rate"] = fin["loan_interest_rate"]
        ov["down_payment_fraction"] = fin["down_payment_fraction"]
        ov["real_discount_rate"] = fin["real_discount_rate"]
        ov["tax_rate"] = fin["tax_rate"]

    # --- regional trajectories ---
    if "load_growth" in files:
        lg = ingest.load_load_growth(files["load_growth"], years,
                                     CENSUS_DIVISIONS)
        if region_kind == "census_division":
            ov["load_growth"] = lg
        else:
            ov["load_growth"] = np.broadcast_to(
                lg.mean(axis=1, keepdims=True),
                (len(years), n_regions, len(SECTORS))).copy()
    if "elec_prices" in files and bas:
        ep = ingest.load_elec_prices(files["elec_prices"], years, bas,
                                     base_year=config.start_year)
        if region_kind == "ba":
            mult = ep
        else:
            mult = np.broadcast_to(
                ep.mean(axis=1, keepdims=True),
                (len(years), n_regions, len(SECTORS))).copy()
        ov["elec_price_multiplier"] = mult
        esc = scen.escalator_from_multipliers(mult, np.asarray(years))
        ov["elec_price_escalator"] = esc.astype(np.float32)

    def _opt(name: str) -> Optional[str]:
        for d in (input_root, os.path.join(input_root, os.pardir, "python")):
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
        return None

    # --- value of resiliency (apply_value_of_resiliency, elec.py:287;
    # shipped vor_FY20 CSV keys on state_abbr + sector_abbr) ---
    v_path = _pick_csv("value_of_resiliency", "vor", "mid")
    if v_path:
        vor_g = ingest.load_value_of_resiliency(v_path, states)
        ov["value_of_resiliency"] = np.broadcast_to(
            vor_g[None, :], (len(years), g)).copy()

    # --- market curves: CSV drop-ins for the reference's Postgres-only
    # tables (max_market_curves_to_model, data_functions.py:370;
    # input_solar_bass_params, data_functions.py:279). Absent these the
    # synthetic uniform_inputs defaults remain — flagged in meta so run
    # outputs cannot be mistaken for dGen adoption numbers. ---
    market_curves = {"mms": "synthetic_default", "bass": "synthetic_default"}
    mmc_path = _opt("max_market_curves.csv")
    if mmc_path:
        ov["mms_table"] = ingest.load_max_market_curves(mmc_path)
        market_curves["mms"] = "ingested"
    bp_path = _opt("bass_params.csv")
    if bp_path:
        bp = ingest.load_bass_params(bp_path, states)
        ov["bass_p"] = bp["bass_p"]
        ov["bass_q"] = bp["bass_q"]
        ov["teq_yr1"] = bp["teq_yr1"]
        market_curves["bass"] = "ingested"
        if bp["missing"]:
            logger.warning(
                "bass_params.csv: %d of %d state x sector groups have no "
                "row (keeping synthetic defaults there)", bp["missing"], g,
            )

    # --- market data ---
    if "observed" in files:
        ov["observed_kw"] = ingest.load_observed_deployment(
            files["observed"], years, states)
    if "attachment" in files:
        per_state = ingest.load_attachment_rates(files["attachment"], states)
        ov["attachment_rate"] = ingest.state_attachment_to_groups(per_state)
    cap_path = os.path.join(input_root,
                            "installed_capacity_mw_by_state_sector.csv")
    if os.path.exists(cap_path):
        ov["starting_kw"] = load_starting_capacities(
            cap_path, config.start_year, states)

    # --- NEM capacity caps (agent_mutation/elec.py:459-478) ---
    # peak_demand_mw.csv + cf_during_peak_demand.csv ship with the
    # reference next to dgen_model.py (read there every model year,
    # dgen_model.py:253-254); the state-limits table lives in its
    # Postgres dump and is accepted here as an exported
    # nem_state_limits.csv in the input root.
    sl_path = _opt("nem_state_limits.csv")
    pk_path = _opt("peak_demand_mw.csv")
    cfp_path = _opt("cf_during_peak_demand.csv")
    nem_caps_source = "uncapped_default"
    if sl_path and pk_path and cfp_path:
        nem_caps_source = "ingested"
        # residential load multiplier for peak-demand growth (reference
        # elec.py:813-814 averages county res growth per state; a
        # state's counties share its census division, so each state
        # takes its OWN division's growth — the division-mean fallback
        # covers only states outside the standard assignment)
        res_mult = None
        if "load_growth" in ov and region_kind == "census_division":
            lg = np.asarray(ov["load_growth"])            # [Y, R, S]
            cd_of = {c: i for i, c in enumerate(regions)}
            fallback = lg[:, :, 0].mean(axis=1)           # [Y]
            res_mult = np.empty((len(years), n_states), np.float32)
            for si, s in enumerate(states):
                cd = STATE_CENSUS_DIVISION.get(s)
                res_mult[:, si] = (
                    lg[:, cd_of[cd], 0] if cd in cd_of else fallback
                )
        elif "load_growth" in ov:
            # BA-keyed regions don't map to states; keep the mean proxy
            lg = np.asarray(ov["load_growth"])
            res_mult = np.broadcast_to(
                lg[:, :, 0].mean(axis=1, keepdims=True),
                (len(years), n_states),
            ).copy()
        ov["nem_cap_kw"] = compile_state_nem_caps_rows(
            _read_csv(sl_path), _read_csv(pk_path), _read_csv(cfp_path),
            years, states, res_mult,
        )

    if overrides:
        ov.update(overrides)

    inputs = scen.uniform_inputs(config, n_groups=g, n_regions=n_regions,
                                 overrides=ov, device=device)
    meta = {
        "regions": regions,
        "bas": bas,
        "wholesale_base_usd_per_kwh": (
            wholesale_base if region_kind == "ba" and len(wholesale_base)
            else np.full(n_regions,
                         float(wholesale_base.mean()) if len(wholesale_base)
                         else 0.04, np.float32)
        ),
        "files": files,
        "market_curves": market_curves,
        # provenance for the other two drop-ins (market_curves carries
        # mms/bass): stamped into every run's meta.json so synthetic
        # defaults are never mistaken for ingested policy data
        "data_sources": {
            "itc": itc_source,
            "nem_caps": nem_caps_source,
        },
    }
    return inputs, meta
