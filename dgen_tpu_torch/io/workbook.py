"""Reference scenario-workbook (.xlsm) reader, stdlib only (port of
``dgen_tpu/io/workbook.py``).

The reference's input artifact is an Excel macro workbook whose named
ranges the loader pushes into Postgres (excel/excel_functions.py:21
``load_scenario``; excel/table_range_lkup.csv maps the 14 run ranges).
In the shipped workbooks (dgen_os/excel/input_sheet_final.xlsm,
2024_input_sheet.xlsm) those ranges are SELECTOR cells on the
'Main - Scenario Options' sheet: each names the trajectory preset (or,
when the value cell says "User Defined", the user table in the next
column) for one input family, plus the main options column
(scenario name / technology / region / markets / end year / seed).

openpyxl is not available in this image, and an .xlsx/.xlsm is just a
zip of XML — so this module parses workbook.xml (defined names),
sharedStrings.xml and the referenced sheets directly with
zipfile + xml.etree (values only, like openpyxl's ``data_only=True``:
formula cells carry their cached <v>). Nothing here needs pandas,
torch or a card.

Consumption path:
  * :func:`read_scenario` -> a :class:`WorkbookScenario` (labels,
    values, per-family selections)
  * :func:`scenario_from_workbook` -> (ScenarioConfig, build info):
    states, sector weights, storage flag, and the ``prefer`` mapping
    that drives io.reference_inputs' per-family CSV selection
  * :func:`export_drop_ins` -> scenario_options.csv + selections.json
    (+ any rectangular range as its own CSV) for operators who want the
    workbook contents as plain files
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import zipfile
import xml.etree.ElementTree as ET
from contextlib import nullcontext as _nullcontext
from typing import Dict, List, Optional, Tuple

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_NS_REL = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships}")

#: named range -> io.reference_inputs / ingest family key
#: (excel/table_range_lkup.csv rows with run=TRUE)
SELECTOR_FAMILIES = {
    "load_growth_user_defined": "load_growth",
    "elec_prices_user_defined": "elec_prices",
    "wholesale_elec_prices_user_defined": "wholesale",
    "pv_price_traj_user_defined": "pv_prices",
    "pv_tech_traj_user_defined": "pv_tech",
    "batt_price_traj_user_defined": "batt_prices",
    "batt_tech_traj_user_defined": "batt_tech",
    "pv_plus_batt_price_traj_user_defined": "pv_plus_batt",
    "financing_terms_user_defined": "financing",
    "deprec_sch_user_defined": "deprec",
    "carbon_intensities_user_defined": "carbon",
    "value_of_resiliency_user_defined": "vor",
}

US_STATE_ABBR = {
    "alabama": "AL", "alaska": "AK", "arizona": "AZ", "arkansas": "AR",
    "california": "CA", "colorado": "CO", "connecticut": "CT",
    "delaware": "DE", "district of columbia": "DC", "florida": "FL",
    "georgia": "GA", "hawaii": "HI", "idaho": "ID", "illinois": "IL",
    "indiana": "IN", "iowa": "IA", "kansas": "KS", "kentucky": "KY",
    "louisiana": "LA", "maine": "ME", "maryland": "MD",
    "massachusetts": "MA", "michigan": "MI", "minnesota": "MN",
    "mississippi": "MS", "missouri": "MO", "montana": "MT",
    "nebraska": "NE", "nevada": "NV", "new hampshire": "NH",
    "new jersey": "NJ", "new mexico": "NM", "new york": "NY",
    "north carolina": "NC", "north dakota": "ND", "ohio": "OH",
    "oklahoma": "OK", "oregon": "OR", "pennsylvania": "PA",
    "rhode island": "RI", "south carolina": "SC", "south dakota": "SD",
    "tennessee": "TN", "texas": "TX", "utah": "UT", "vermont": "VT",
    "virginia": "VA", "washington": "WA", "west virginia": "WV",
    "wisconsin": "WI", "wyoming": "WY",
}

#: ISO/RTO region names the reference workbook accepts -> state lists
ISO_STATES = {
    "ercot": ["TX"],
    "caiso": ["CA"],
    "isone": ["CT", "MA", "ME", "NH", "RI", "VT"],
    "iso-ne": ["CT", "MA", "ME", "NH", "RI", "VT"],
    "nyiso": ["NY"],
}


def _col_to_idx(col: str) -> int:
    i = 0
    for ch in col:
        i = i * 26 + (ord(ch) - ord("A") + 1)
    return i


def _idx_to_col(i: int) -> str:
    out = ""
    while i:
        i, rem = divmod(i - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _split_ref(ref: str) -> Tuple[str, int]:
    m = re.match(r"\$?([A-Z]+)\$?(\d+)$", ref)
    if not m:
        raise ValueError(f"bad cell ref {ref!r}")
    return m.group(1), int(m.group(2))


class _Workbook:
    """Values-only view over an .xlsx/.xlsm zip (context manager)."""

    def __init__(self, path: str) -> None:
        self.z = zipfile.ZipFile(path)
        self.strings = self._shared_strings()
        self.sheet_files = self._sheet_files()
        self._cells: Dict[str, Dict[Tuple[int, str], object]] = {}

    def close(self) -> None:
        self.z.close()

    def __enter__(self) -> "_Workbook":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _shared_strings(self) -> List[str]:
        try:
            data = self.z.read("xl/sharedStrings.xml")
        except KeyError:
            return []
        root = ET.parse(io.BytesIO(data)).getroot()
        return [
            "".join(t.text or "" for t in si.iter(f"{_NS}t"))
            for si in root.findall(f"{_NS}si")
        ]

    def _sheet_files(self) -> Dict[str, str]:
        wb = ET.parse(io.BytesIO(self.z.read("xl/workbook.xml"))).getroot()
        rels = ET.parse(io.BytesIO(
            self.z.read("xl/_rels/workbook.xml.rels"))).getroot()
        targets = {
            rel.get("Id"): rel.get("Target")
            for rel in rels
        }
        out = {}
        for sh in wb.iter(f"{_NS}sheet"):
            t = targets.get(sh.get(f"{_NS_REL}id"))
            if t:
                out[sh.get("name")] = (
                    t if t.startswith("xl/") else f"xl/{t.lstrip('/')}")
        return out

    @staticmethod
    def _is_multi_area(target: str) -> bool:
        """True for multi-area targets ('Sheet1!$A$1,Sheet1!$B$2') —
        commas INSIDE a quoted sheet name ('Summary, FY24'!$A$1) are
        not area separators and must not trigger the skip."""
        in_quote = False
        for ch in target:
            if ch == "'":
                in_quote = not in_quote
            elif ch == "," and not in_quote:
                return True
        return False

    def defined_names(self) -> Dict[str, Tuple[str, str]]:
        """{name: (sheet, cell_range)}; broken (#REF!) and multi-area
        names (rsplit would mangle the sheet and a later lookup would
        KeyError) are skipped."""
        wb = ET.parse(io.BytesIO(self.z.read("xl/workbook.xml"))).getroot()
        out = {}
        for dn in wb.iter(f"{_NS}definedName"):
            target = (dn.text or "").strip()
            if ("#REF!" in target or "!" not in target
                    or self._is_multi_area(target)):
                continue
            sheet, ref = target.rsplit("!", 1)
            out[dn.get("name")] = (sheet.strip("'"), ref)
        return out

    def sheet_cells(self, sheet: str) -> Dict[Tuple[int, str], object]:
        """{(row, col): value} for one sheet, cached, values-only."""
        if sheet in self._cells:
            return self._cells[sheet]
        path = self.sheet_files[sheet]
        cells: Dict[Tuple[int, str], object] = {}
        for _, el in ET.iterparse(io.BytesIO(self.z.read(path))):
            if el.tag != f"{_NS}c":
                continue
            ref = el.get("r")
            if not ref:
                continue
            col, row = _split_ref(ref)
            v = el.find(f"{_NS}v")
            if v is None or v.text is None:
                el.clear()
                continue
            val: object = v.text
            t = el.get("t")
            if t == "s":
                val = self.strings[int(v.text)]
            elif t != "str":
                try:
                    f = float(v.text)
                    val = int(f) if f == int(f) else f
                except ValueError:
                    pass
            cells[(row, col)] = val
            el.clear()
        self._cells[sheet] = cells
        return cells

    def range_values(self, sheet: str, ref: str) -> List[List[object]]:
        """Rectangular values (rows of columns) for A1:B2-style refs."""
        if ":" in ref:
            tl, br = ref.split(":")
        else:
            tl = br = ref
        c0, r0 = _split_ref(tl)
        c1, r1 = _split_ref(br)
        cells = self.sheet_cells(sheet)
        return [
            [
                cells.get((r, _idx_to_col(ci)))
                for ci in range(_col_to_idx(c0), _col_to_idx(c1) + 1)
            ]
            for r in range(r0, r1 + 1)
        ]


@dataclasses.dataclass(frozen=True)
class WorkbookScenario:
    """Decoded 'Main - Scenario Options' contents."""

    options: Dict[str, object]        # label -> value (self-describing)
    selections: Dict[str, str]        # family key -> trajectory name
    agent_file: Optional[str]
    path: str

    @property
    def name(self) -> str:
        return str(self.options.get("Scenario Name", "workbook"))

    @property
    def end_year(self) -> int:
        return int(self.options.get("Analysis End Year", 2050))

    @property
    def storage_enabled(self) -> bool:
        return "storage" in str(self.options.get("Technology", "")).lower()

    @property
    def region(self) -> str:
        return str(self.options.get("Region to Analyze", "National")).strip()

    @property
    def markets(self) -> str:
        return str(self.options.get("Markets", "All")).strip()

    @property
    def seed(self) -> int:
        try:
            return int(self.options.get("Random Generator Seed", 0))
        except (TypeError, ValueError):
            return 0


def read_named_ranges(
    path: str, names: Optional[List[str]] = None, _wb=None
) -> Dict[str, object]:
    """{name: scalar or rows} for the workbook's defined names
    (single-cell ranges collapse to their value)."""
    ctx = _Workbook(path) if _wb is None else _nullcontext(_wb)
    with ctx as wb:
        dn = wb.defined_names()
        out: Dict[str, object] = {}
        for name, (sheet, ref) in dn.items():
            if names is not None and name not in names:
                continue
            rows = wb.range_values(sheet, ref)
            if len(rows) == 1 and len(rows[0]) == 1:
                out[name] = rows[0][0]
            else:
                out[name] = rows
        return out


def read_scenario(path: str, _wb=None) -> WorkbookScenario:
    """Decode the Main-sheet scenario options + the 14 run selectors.

    The options column (named range ``scenario_options_main``) is
    positionally defined in the reference's Postgres schema; here the
    sheet is self-describing — the label column sits immediately LEFT
    of the value column and the user-defined table column immediately
    RIGHT (input_sheet_final.xlsm layout C/D/E), so labels are read
    from the sheet rather than hard-coded.
    """
    ctx = _Workbook(path) if _wb is None else _nullcontext(_wb)
    with ctx as wb:
        return _read_scenario(wb, path)


def _read_scenario(wb: _Workbook, path: str) -> WorkbookScenario:
    dn = wb.defined_names()
    if "scenario_options_main" not in dn:
        raise ValueError(f"{path}: no scenario_options_main named range")
    sheet, ref = dn["scenario_options_main"]
    tl, br = (ref.split(":") + [ref])[:2]
    vcol, r0 = _split_ref(tl)
    _, r1 = _split_ref(br)
    lcol = _idx_to_col(_col_to_idx(vcol) - 1)
    cells = wb.sheet_cells(sheet)

    options: Dict[str, object] = {}
    for r in range(r0, r1 + 1):
        label = cells.get((r, lcol))
        if label is None:
            continue
        options[str(label).strip()] = cells.get((r, vcol))

    selections: Dict[str, str] = {}
    agent_file = None
    for range_name, family in SELECTOR_FAMILIES.items():
        if range_name not in dn:
            continue
        s_sheet, s_ref = dn[range_name]
        col, row = _split_ref(s_ref.split(":")[0])
        sc = wb.sheet_cells(s_sheet)
        # the named range points at the USER-table column; when that
        # cell is empty the scenario chose a named preset, which lives
        # one column left (the workbook's Value column)
        val = sc.get((row, col))
        if val is None or not str(val).strip():
            val = sc.get((row, _idx_to_col(_col_to_idx(col) - 1)))
        if val is not None and "user defined" in str(val).lower():
            val = sc.get((row, _idx_to_col(_col_to_idx(col) + 1)))
        if val is not None and str(val).strip():
            selections[family] = str(val).strip()
    if "agent_file_user_defined" in dn:
        s_sheet, s_ref = dn["agent_file_user_defined"]
        col, row = _split_ref(s_ref.split(":")[0])
        agent_file = wb.sheet_cells(s_sheet).get((row, col))
        if agent_file is not None:
            agent_file = str(agent_file)

    return WorkbookScenario(
        options=options, selections=selections,
        agent_file=agent_file, path=path,
    )


def resolve_states(region: str) -> Optional[List[str]]:
    """Workbook region string -> state list (None = national)."""
    r = region.strip().lower()
    if r in ("national", "united states", "usa", "us", ""):
        return None
    if r in ISO_STATES:
        return list(ISO_STATES[r])
    if r in US_STATE_ABBR:
        return [US_STATE_ABBR[r]]
    if len(region) == 2 and region.upper() in US_STATE_ABBR.values():
        return [region.upper()]
    raise ValueError(f"workbook region {region!r} not recognized")


def resolve_sector_weights(markets: str) -> Tuple[float, float, float]:
    m = markets.strip().lower()
    if "only residential" in m:
        return (1.0, 0.0, 0.0)
    if "only commercial" in m:
        return (0.0, 1.0, 0.0)
    if "only industrial" in m:
        return (0.0, 0.0, 1.0)
    return (0.7, 0.2, 0.1)


def scenario_from_workbook(path: str, start_year: int = 2014):
    """(ScenarioConfig, info) from a workbook: the bridge from the
    reference's input artifact to a runnable configuration.

    ``info`` carries states (None = national), sector_weights, seed,
    agent_file provenance, and ``prefer`` — the per-family trajectory
    selections consumed by io.reference_inputs (unmatched selections
    fall back to defaults there, mirroring how the reference treats a
    missing Postgres preset as an error the operator resolves)."""
    from dgen_tpu_torch.config import ScenarioConfig

    ws = read_scenario(path)
    cfg = ScenarioConfig(
        name=re.sub(r"\W+", "_", ws.name).strip("_") or "workbook",
        start_year=start_year,
        end_year=max(ws.end_year, start_year + 2),
        storage_enabled=ws.storage_enabled,
        anchor_years=(),
    )
    info = {
        "states": resolve_states(ws.region),
        "sector_weights": resolve_sector_weights(ws.markets),
        "seed": ws.seed,
        "agent_file": ws.agent_file,
        "prefer": dict(ws.selections),
        "workbook": os.path.basename(path),
    }
    return cfg, info


def export_drop_ins(path: str, out_dir: str) -> Dict[str, str]:
    """Write the workbook's contents as plain files:
    scenario_options.csv (label,value), selections.json (per-family
    trajectory choices), and any rectangular named range from the run
    mapping as <name>.csv. Returns {artifact: path}."""
    import csv

    from dgen_tpu_torch.utils.atomic import atomic_write, atomic_write_json

    os.makedirs(out_dir, exist_ok=True)
    out: Dict[str, str] = {}
    with _Workbook(path) as wb:
        ws = _read_scenario(wb, path)

        opt_path = os.path.join(out_dir, "scenario_options.csv")

        def _write_options(tmp: str) -> None:
            with open(tmp, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["option", "value"])
                for k, v in ws.options.items():
                    w.writerow([k, "" if v is None else v])

        atomic_write(opt_path, _write_options)
        out["scenario_options"] = opt_path

        sel_path = os.path.join(out_dir, "selections.json")
        atomic_write_json(
            sel_path,
            {"selections": ws.selections, "agent_file": ws.agent_file,
             "workbook": os.path.basename(path)},
            indent=1,
        )
        out["selections"] = sel_path

        ranges = read_named_ranges(
            path, names=list(SELECTOR_FAMILIES) + ["scenario_options_main"],
            _wb=wb,
        )
        for name, val in ranges.items():
            if isinstance(val, list) and name != "scenario_options_main":
                p = os.path.join(out_dir, f"{name}.csv")

                def _write_range(tmp: str, rows=val) -> None:
                    with open(tmp, "w", newline="") as f:
                        w = csv.writer(f)
                        for row in rows:
                            w.writerow(
                                ["" if c is None else c for c in row])

                atomic_write(p, _write_range)
                out[name] = p
    return out
