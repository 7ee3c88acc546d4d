"""Write a small synthetic input root in the reference's formats.

    python tests/torch_fixtures/reference_inputs/make_reference_inputs.py [OUT_DIR]

writes, under ``OUT_DIR`` (this directory by default), the layout of the
reference's ``dgen_os`` tree that the ingest reads:

* ``dgen_os/input_data/``: one directory per trajectory family, in the
  columns the loaders of ``io.ingest`` and ``io.reference_inputs`` parse,
  and the top-level market tables and drop-ins (installed capacity,
  observed deployment, attachment rates, ITC schedule, NEM state limits,
  max market curves, Bass parameters, the hourly wholesale shape);
* ``dgen_os/python/``: peak demand and the solar CF during the peak,
  beside ``input_data/`` as the reference ships them;
* ``dgen_os/excel/scenario.xlsm``: a minimal scenario workbook (defined
  names, shared strings, the "Main - Scenario Options" sheet).

The values are drawn from a fixed seed with numpy and sit in the
reference's ranges; the layout exercises the ingest's branches: years
with gaps (forward fill, end clamping), two candidates in some family
directories (the first-match and last-match picking rules, a preference
that beats the default), attachment rows with a blank cell and with
zero volumes, Bass parameters missing for some groups, NEM limits with a
blank window, a non-numeric cell, a cap that binds from the second model
year and one with a sunset year. Every file is written in a fixed order
with fixed formats, and the workbook's zip entries are stored with a
fixed time stamp, so a re-run reproduces the same bytes.
"""

from __future__ import annotations

import os
import sys
import zipfile
from typing import List, Sequence

import numpy as np

SEED = 19

STATES = (
    "AL AR AZ CA CO CT DC DE FL GA IA ID IL IN KS KY LA MA MD ME MI MN MO MS "
    "MT NC ND NE NH NJ NM NV NY OH OK OR PA RI SC SD TN TX UT VA VT WA WI WV WY"
).split()
SECTORS = ("res", "com", "ind")
DIVISIONS = ("NE", "MA", "ENC", "WNC", "SA", "ESC", "WSC", "MTN", "PAC")
#: ReEDS balancing areas of the price files
BAS = tuple(f"p{i}" for i in (1, 10, 19, 33, 48, 60, 63, 67, 80, 97, 101, 127))

#: trajectory years: gaps (2017, 2019, ...) and an end before 2050, so the
#: model-year grid is forward filled and clamped at the end
TRAJ_YEARS = (2014, 2015, 2016, 2018, 2020, 2022, 2025, 2030, 2035, 2040, 2045)
#: a later start, so the first model year clamps to the first row
LATE_YEARS = TRAJ_YEARS[1:]

#: the states whose NEM caps the fixture sets apart: TX's cap binds from
#: 2016 (its window opens then, below the state's installed capacity), CA's
#: stops binding after its sunset year
CAP_FROM_2016, CAP_SUNSET = "TX", "CA"


def _fmt(x: float, digits: int) -> str:
    return f"{x:.{digits}f}"


def _write_csv(path: str, header: Sequence[str], rows: List[Sequence[str]]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(r) + "\n")


def _decline(rng, years, start, end_frac, digits, noise=0.02) -> List[str]:
    """A declining trajectory from ``start`` to ``start * end_frac``."""
    t = (np.asarray(years, float) - years[0]) / (years[-1] - years[0])
    vals = start * (1.0 - (1.0 - end_frac) * t) * (1.0 + noise * rng.uniform(-1, 1, len(t)))
    return [_fmt(v, digits) for v in vals]


def _stacked(rng, path, years, fields, nonres=False) -> None:
    """``year,<field>_res,<field>_com,<field>_ind`` (or ``_res,_nonres``):
    ``fields`` maps each field to (start, end fraction, digits)."""
    secs = ("res", "nonres") if nonres else SECTORS
    header, cols = ["year"], []
    for field, (start, frac, digits) in fields.items():
        for si, s in enumerate(secs):
            header.append(f"{field}_{s}")
            cols.append(_decline(rng, years, start * (1.0 - 0.12 * si), frac, digits))
    rows = [[str(y)] + [c[i] for c in cols] for i, y in enumerate(years)]
    _write_csv(path, header, rows)


def trajectories(rng, inp: str) -> None:
    for name, capex in (("pv_price_atb19_mid", 3400.0), ("pv_price_atb23_mid", 2900.0)):
        _stacked(rng, os.path.join(inp, "pv_prices", f"{name}.csv"), TRAJ_YEARS,
                 {"system_capex_per_kw": (capex, 0.55, 2),
                  "system_om_per_kw": (24.0, 0.7, 3)})
    _stacked(rng, os.path.join(inp, "pv_tech_performance", "pv_tech_performance_FY19.csv"),
             LATE_YEARS, {"pv_degradation_factor": (0.005, 1.0, 5)})
    for name, kwh in (("batt_prices_FY19_mid", 820.0), ("batt_prices_FY19_high", 980.0)):
        _stacked(rng, os.path.join(inp, "batt_prices", f"{name}.csv"), TRAJ_YEARS,
                 {"batt_capex_per_kwh": (kwh, 0.5, 2),
                  "batt_capex_per_kw": (1250.0, 0.6, 2)}, nonres=True)
    _stacked(rng, os.path.join(inp, "pv_plus_batt_prices", "pv_plus_batt_prices_FY19_mid.csv"),
             TRAJ_YEARS, {"system_capex_per_kw": (3550.0, 0.55, 2),
                          "batt_capex_per_kwh": (780.0, 0.5, 2)}, nonres=True)
    _stacked(rng, os.path.join(inp, "batt_tech_performance", "batt_tech_performance_FY19.csv"),
             TRAJ_YEARS, {"batt_eff": (0.88, 1.04, 4), "batt_lifetime_yrs": (10.0, 1.5, 0)})
    for name, rate in (("financing_atb_FY19", 0.054), ("financing_atb_FY23", 0.062)):
        path = os.path.join(inp, "financing_terms", f"{name}.csv")
        fields = {"loan_term_yrs": (20.0, 1.0, 0), "loan_interest_rate": (rate, 0.9, 4),
                  "down_payment_fraction": (0.2, 1.0, 3),
                  "real_discount_rate": (0.03, 1.0, 4), "tax_rate": (0.26, 1.0, 3)}
        _stacked(rng, path, TRAJ_YEARS, fields, nonres=True)
        # economic_lifetime_yrs rides every row, as in the reference's files
        with open(path) as f:
            lines = f.read().splitlines()
        with open(path, "w", newline="") as f:
            f.write(lines[0] + ",economic_lifetime_yrs\n")
            for line in lines[1:]:
                f.write(line + ",25\n")
    # depreciation: MACRS 5 for com/ind, all-zero res rows (no depreciation)
    macrs = ("0.2", "0.32", "0.192", "0.1152", "0.1152", "0.0576")
    rows = []
    for y in (2014, 2018, 2024):
        for s in SECTORS:
            rows.append([str(y), s] + (["0"] * 6 if s == "res" else list(macrs)))
    _write_csv(os.path.join(inp, "depreciation_schedules", "deprec_sch_FY19.csv"),
               ["year", "sector_abbr", "1", "2", "3", "4", "5", "6"], rows)
    # load growth by census division: the reference case, and the
    # high-electrification case national-all-sector prefers
    for name, top in (("AEO2019_Reference", 0.12), ("Experimental_high_electrification", 0.45)):
        rows = []
        for di, d in enumerate(DIVISIONS):
            scale = top * (0.7 + 0.06 * di)
            for y in TRAJ_YEARS:
                t = (y - 2014) / 31.0
                g = [scale * t * (1.0 - 0.2 * si) + 0.002 * rng.uniform(-1, 1)
                     for si in range(3)]
                rows.append([str(y)] + [_fmt(v, 5) for v in g] + [d])
        _write_csv(os.path.join(inp, "load_growth", f"{name}.csv"),
                   ["year", "load_growth_res", "load_growth_com", "load_growth_ind",
                    "census_division_abbr"], rows)
    # retail prices by BA ($/kWh); p127 has no rows (multiplier 1)
    for name, growth in (("ATB19_Mid_Case_retail", 0.25), ("ATB19_High_Case_retail", 0.55)):
        rows = []
        for bi, ba in enumerate(BAS[:-1]):
            base = [0.11 + 0.004 * bi, 0.095 + 0.003 * bi, 0.07 + 0.002 * bi]
            for y in LATE_YEARS:
                t = (y - LATE_YEARS[0]) / (LATE_YEARS[-1] - LATE_YEARS[0])
                rows.append([ba, str(y)] + [
                    _fmt(b * (1.0 + growth * t) * (1.0 + 0.01 * rng.uniform(-1, 1)), 5)
                    for b in base])
        _write_csv(os.path.join(inp, "elec_prices", f"{name}.csv"),
                   ["ba", "year", "elec_price_res", "elec_price_com", "elec_price_ind"], rows)
    # wholesale prices by BA, one column a year ($/kWh); two Mid_Case files
    for name, level in (("ATB19_Mid_Case_wholesale", 0.034), ("ATB23_Mid_Case_wholesale", 0.041)):
        rows = [[ba] + _decline(rng, TRAJ_YEARS, level * (1.0 + 0.05 * bi), 1.35, 5)
                for bi, ba in enumerate(BAS)]
        _write_csv(os.path.join(inp, "wholesale_electricity_prices", f"{name}.csv"),
                   ["ba"] + [str(y) for y in TRAJ_YEARS], rows)
    # carbon intensity by state (tCO2/kWh), one column a year
    rows = []
    for s in STATES:
        rows.append([s] + _decline(rng, LATE_YEARS, 0.00035 + 0.0005 * rng.random(),
                                   0.5, 7))
    _write_csv(os.path.join(inp, "carbon_intensities", "carbon_intensities_FY19.csv"),
               ["state_abbr"] + [str(y) for y in LATE_YEARS], rows)
    # value of resiliency ($ an agent): com and ind only, as shipped
    rows = [[s, sec, _fmt(v, 2)] for s in STATES for sec, v in
            (("com", 1500.0 + 3000.0 * rng.random()), ("ind", 20000.0 + 60000.0 * rng.random()))]
    _write_csv(os.path.join(inp, "value_of_resiliency", "vor_FY20_mid.csv"),
               ["state_abbr", "sector_abbr", "value_of_resiliency_usd"], rows)


def market_tables(rng, inp: str, py: str) -> None:
    # installed capacity (MW) by state x sector in 2012, 2014 and 2016: the
    # start year 2014 picks its own rows
    cap = {s: 30.0 + 2500.0 * rng.random() ** 2 for s in STATES}
    rows = []
    for y in (2012, 2014, 2016):
        grow = {2012: 0.55, 2014: 1.0, 2016: 1.7}[y]
        for s in STATES:
            for si, sec in enumerate(SECTORS):
                rows.append([s, sec, str(y), _fmt(cap[s] * grow * (0.6, 0.3, 0.1)[si], 3)])
    _write_csv(os.path.join(inp, "installed_capacity_mw_by_state_sector.csv"),
               ["state_abbr", "sector_abbr", "year", "observed_capacity_mw"], rows)
    rows = []
    for s in STATES:
        for si, sec in enumerate(SECTORS):
            for y in range(2014, 2024):
                rows.append([s, sec, str(y),
                             _fmt(cap[s] * (0.6, 0.3, 0.1)[si] * 1.18 ** (y - 2014), 3)])
    _write_csv(os.path.join(inp, "observed_deployment_by_state_sector_2023.csv"),
               ["state_abbr", "sector_abbr", "year", "observed_solar_mw"], rows)
    # attachment rates: quarterly rate and install-volume rows; MT has a
    # blank rate cell, WY zero volumes (the plain mean), VT no rows (0)
    quarters = ("q2_24", "q3_24", "q4_24", "q1_25")
    rows = []
    for s in STATES:
        if s == "VT":
            continue
        rates = [_fmt(0.05 + 0.5 * rng.random(), 4) for _ in quarters]
        vols = [str(int(200 + 5000 * rng.random())) for _ in quarters]
        if s == "MT":
            rates[1] = ""
        if s == "WY":
            vols = ["0"] * len(quarters)
        rows.append([s, "attachment_rate"] + rates)
        rows.append([s, "install_volume"] + vols)
    _write_csv(os.path.join(inp, "ohm_attachment_rates.csv"),
               ["state_abbr", "metric", *quarters], rows)
    rows = [[str(y), "0.3", "0.3", "0.3"] for y in (2014, 2020)]
    rows += [[str(y), "0.26", "0.26", "0.26"] for y in (2021,)]
    rows += [[str(y), "0.3", "0.3", "0.3"] for y in (2022, 2032)]
    rows += [[str(y), "0", "0.1", "0.1"] for y in (2035, 2050)]
    _write_csv(os.path.join(inp, "itc_schedule.csv"),
               ["year", "itc_fraction_res", "itc_fraction_com", "itc_fraction_ind"], rows)
    # NEM state limits: MW ceilings, % of peak, availability windows
    rows = []
    for i, s in enumerate(STATES):
        if i % 3 == 2 and s not in (CAP_FROM_2016, CAP_SUNSET):
            continue                                 # no row: never capped
        max_mw = _fmt(cap[s] * (3.0 + 4.0 * rng.random()), 1)
        max_pct = _fmt(5.0 + 10.0 * rng.random(), 2)
        first, sunset = "2014", str(2030 + int(10 * rng.random()))
        if i % 4 == 0:
            max_mw = ""                              # the % of peak alone
        if i % 5 == 1:
            first, sunset = "", ""                   # a blank window: always
        if s == CAP_FROM_2016:
            max_mw, first = _fmt(cap[s] * 0.5, 1), "2016"
        if s == CAP_SUNSET:
            max_mw, max_pct, sunset = _fmt(cap[s] * 0.4, 1), "", "2018"
        if s == "OH":
            max_pct = "unknown"                      # a non-numeric cell
        rows.append([s, max_mw, max_pct, first, sunset])
    _write_csv(os.path.join(inp, "nem_state_limits.csv"),
               ["state_abbr", "max_cum_capacity_mw", "max_pct_cum_capacity",
                "first_year", "sunset_year"], rows)
    # max market share by payback (years), host-owned, with decoy rows
    rows = []
    for sec, scale, tau in (("res", 0.95, 6.0), ("com", 0.8, 4.0), ("ind", 0.7, 3.5)):
        for pb in range(0, 31):
            rows.append([str(pb), sec, _fmt(scale * np.exp(-pb / tau), 6),
                         "payback_period", "host_owned"])
        rows.append(["5", sec, "0.99", "percent_monthly_bill_savings", "host_owned"])
        rows.append(["5", sec, "0.99", "payback_period", "tpo"])
    _write_csv(os.path.join(inp, "max_market_curves.csv"),
               ["metric_value", "sector_abbr", "max_market_share", "metric",
                "business_model"], rows)
    # Bass parameters: solar rows for most groups (none for ind in every
    # fourth state), a wind row that must be ignored
    rows = []
    for i, s in enumerate(STATES):
        for sec in SECTORS:
            if sec == "ind" and i % 4 == 0:
                continue
            rows.append([s, _fmt(0.0008 + 0.004 * rng.random(), 5),
                         _fmt(0.3 + 0.25 * rng.random(), 4),
                         _fmt(2.0 + 6.0 * rng.random(), 3), sec, "solar"])
    rows.append(["TX", "0.009", "0.9", "9.0", "res", "wind"])
    _write_csv(os.path.join(inp, "bass_params.csv"),
               ["state_abbr", "p", "q", "teq_yr1", "sector_abbr", "tech"], rows)
    # hourly wholesale shape: a national column and two divisions' own
    h = np.arange(8760)
    day, season = (h % 24) / 24.0, h / 8760.0
    base = 1.0 + 0.35 * np.sin(2 * np.pi * (day - 0.3)) + 0.15 * np.cos(2 * np.pi * season)
    wsc = base + 0.25 * np.sin(2 * np.pi * (day - 0.45)) ** 2
    pac = base - 0.3 * np.exp(-((day - 0.55) / 0.12) ** 2)
    noise = rng.uniform(-0.05, 0.05, (3, 8760))
    cols = np.stack([base, wsc, pac]) + noise
    _write_csv(os.path.join(inp, "wholesale_hourly_shape.csv"), ["shape", "WSC", "PAC"],
               [[_fmt(v, 4) for v in cols[:, t]] for t in range(8760)])
    # beside input_data/: peak demand (MW, 2014) and the CF during the peak
    _write_csv(os.path.join(py, "peak_demand_mw.csv"), ["state_abbr", "peak_demand_mw_2014"],
               [[s, _fmt(2000.0 + 60000.0 * rng.random(), 1)] for s in STATES])
    _write_csv(os.path.join(py, "cf_during_peak_demand.csv"),
               ["state_abbr", "solar_cf_during_peak_demand_period"],
               [[s, "0" if s == "ND" else _fmt(0.2 + 0.4 * rng.random(), 4)]
                for s in STATES])


# ---------------------------------------------------------------------------
# the scenario workbook
# ---------------------------------------------------------------------------

SHEET = "Main - Scenario Options"
_NS = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_NS_R = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"

#: (row, column) -> value on the sheet: the options column (labels in C,
#: values in D) and the selector rows (value in D, user table in E, the
#: user table's name in F)
CELLS = {
    (2, "C"): "Scenario Options", (2, "D"): "Value", (2, "E"): "User Defined",
    (3, "C"): "Scenario Name", (3, "D"): "ercot fixture",
    (4, "C"): "Technology", (4, "D"): "Solar + Storage",
    (5, "C"): "Region to Analyze", (5, "D"): "ERCOT",
    (6, "C"): "Markets", (6, "D"): "All",
    (7, "C"): "Analysis End Year", (7, "D"): 2030,
    (8, "C"): "Random Generator Seed", (8, "D"): 7,
    # a preset name in the user-table column
    (12, "C"): "Load Growth Scenario", (12, "D"): "AEO2019 Reference",
    (12, "E"): "Experimental",
    # "User Defined": the table named in the next column
    (13, "C"): "Financing Terms", (13, "D"): "User Defined", (13, "E"): "User Defined",
    (13, "F"): "financing_atb_FY23",
    # an empty user-table cell: the Value column's preset
    (14, "C"): "PV Prices", (14, "D"): "pv_price_atb23_mid",
    (15, "C"): "Retail Electricity Prices", (15, "D"): "ATB19_High_Case_retail",
    # a rectangular range (exported as its own CSV)
    (16, "C"): "Wholesale Electricity Prices", (16, "E"): "ATB19_Mid_Case_wholesale",
    (16, "F"): 2014, (17, "E"): "ATB23_Mid_Case_wholesale", (17, "F"): 2.5,
    (20, "C"): "Agent File", (20, "E"): "agent_df_base_ercot",
}
NAMES = {
    "scenario_options_main": "$D$3:$D$8",
    "load_growth_user_defined": "$E$12",
    "financing_terms_user_defined": "$E$13",
    "pv_price_traj_user_defined": "$E$14",
    "elec_prices_user_defined": "$E$15",
    "wholesale_elec_prices_user_defined": "$E$16:$F$17",
    "agent_file_user_defined": "$E$20",
}


def _xml(text: str) -> str:
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def workbook_parts() -> dict:
    strings: List[str] = []
    for v in CELLS.values():
        if isinstance(v, str) and v not in strings:
            strings.append(v)
    rows = {}
    for (r, c), v in sorted(CELLS.items()):
        if isinstance(v, str):
            cell = f'<c r="{c}{r}" t="s"><v>{strings.index(v)}</v></c>'
        else:
            cell = f'<c r="{c}{r}"><v>{v}</v></c>'
        rows.setdefault(r, []).append(cell)
    sheet = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
             f'<worksheet xmlns="{_NS}"><sheetData>'
             + "".join(f'<row r="{r}">{"".join(cells)}</row>' for r, cells in rows.items())
             + "</sheetData></worksheet>")
    shared = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
              f'<sst xmlns="{_NS}" count="{len(strings)}" uniqueCount="{len(strings)}">'
              + "".join(f"<si><t>{_xml(s)}</t></si>" for s in strings) + "</sst>")
    names = "".join(f"<definedName name=\"{n}\">'{SHEET}'!{ref}</definedName>"
                    for n, ref in NAMES.items())
    book = (f'<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
            f'<workbook xmlns="{_NS}" xmlns:r="{_NS_R}"><sheets>'
            f'<sheet name="{SHEET}" sheetId="1" r:id="rId1"/></sheets>'
            f"<definedNames>{names}</definedNames></workbook>")
    rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
            'relationships"><Relationship Id="rId1" Type="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships/worksheet" '
            'Target="worksheets/sheet1.xml"/></Relationships>')
    types = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
             '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
             '<Default Extension="xml" ContentType="application/xml"/>'
             '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.ms-excel.'
             'sheet.macroEnabled.main+xml"/></Types>')
    return {"[Content_Types].xml": types, "xl/workbook.xml": book,
            "xl/_rels/workbook.xml.rels": rels, "xl/sharedStrings.xml": shared,
            "xl/worksheets/sheet1.xml": sheet}


def write_workbook(path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for name, text in workbook_parts().items():
            info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o644 << 16
            z.writestr(info, text.encode("utf-8"))


def generate(out_dir: str) -> None:
    rng = np.random.default_rng(SEED)
    root = os.path.join(out_dir, "dgen_os")
    inp = os.path.join(root, "input_data")
    trajectories(rng, inp)
    market_tables(rng, inp, os.path.join(root, "python"))
    write_workbook(os.path.join(root, "excel", "scenario.xlsm"))


if __name__ == "__main__":
    generate(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
