"""The host-input layer of the PyTorch port against the JAX package's, on
the committed reference-format input root
(``tests/torch_fixtures/reference_inputs``, written by its
``make_reference_inputs.py``): every loader of ``io.ingest`` and
``io.reference_inputs`` bit for bit, their refusals, the
``ScenarioInputs`` of five roots field by field and bit for bit, the NEM
caps compiled from CSV rows against the JAX package's pandas compile,
``store.csv_to_bank``, the scenario workbook, the ``ingest`` fault site,
and the generator's reproducibility."""

import dataclasses
import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from dgen_tpu import config as jcfg
from dgen_tpu.io import ingest as jingest
from dgen_tpu.io import nem as jnem
from dgen_tpu.io import reference_inputs as jri
from dgen_tpu.io import store as jstore
from dgen_tpu.io import workbook as jwb
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import ingest, nem, reference_inputs, store, synth, workbook
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.resilience.supervisor import TRANSIENT, classify_error

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures",
                       "reference_inputs")
ROOT = os.path.join(FIXTURE, "dgen_os", "input_data")
PYDIR = os.path.join(FIXTURE, "dgen_os", "python")
XLSM = os.path.join(FIXTURE, "dgen_os", "excel", "scenario.xlsm")
STATES = list(synth.STATES)
YEARS = list(range(2014, 2051, 2))


def _path(*parts):
    return os.path.join(ROOT, *parts)


def _same(got, ref, what=""):
    """Bit for bit: the same dtype, shape and bits (NaN where NaN)."""
    got, ref = np.atleast_1d(np.asarray(got)), np.atleast_1d(np.asarray(ref))
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.dtype, ref.dtype,
                                                               got.shape, ref.shape)
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8)), what


def _same_tree(got, ref, what=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _same_tree(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, np.ndarray):
        _same(got, ref, what)
    else:
        assert got == ref, what


# ---------------------------------------------------------------------------
# the loaders, bit for bit
# ---------------------------------------------------------------------------

LOADERS = {
    "stacked": lambda m: m.load_stacked_sectors(
        _path("pv_prices", "pv_price_atb19_mid.csv"), "system_capex_per_kw", YEARS),
    "stacked_late_start": lambda m: m.load_stacked_sectors(
        _path("pv_tech_performance", "pv_tech_performance_FY19.csv"),
        "pv_degradation_factor", YEARS),
    "stacked_nonres": lambda m: m.load_stacked_sectors(
        _path("batt_prices", "batt_prices_FY19_mid.csv"), "batt_capex_per_kw", YEARS,
        nonres_suffix=True),
    "batt_tech": lambda m: m.load_batt_tech(
        _path("batt_tech_performance", "batt_tech_performance_FY19.csv"), YEARS),
    "deprec": lambda m: m.load_depreciation_schedules(
        _path("depreciation_schedules", "deprec_sch_FY19.csv"), YEARS),
    "carbon": lambda m: m.load_carbon_intensities(
        _path("carbon_intensities", "carbon_intensities_FY19.csv"), YEARS, STATES),
    "carbon_missing_states": lambda m: m.load_carbon_intensities(
        _path("carbon_intensities", "carbon_intensities_FY19.csv"), YEARS,
        ["TX", "XX", "CA"]),
    "financing": lambda m: m.load_financing_terms(
        _path("financing_terms", "financing_atb_FY23.csv"), YEARS),
    "load_growth": lambda m: m.load_load_growth(
        _path("load_growth", "Experimental_high_electrification.csv"), YEARS,
        jri.CENSUS_DIVISIONS),
    "elec_prices": lambda m: m.load_elec_prices(
        _path("elec_prices", "ATB19_Mid_Case_retail.csv"), YEARS,
        ["p1", "p10", "p127", "p48"], base_year=2014),
    "elec_prices_first_year_base": lambda m: m.load_elec_prices(
        _path("elec_prices", "ATB19_High_Case_retail.csv"), YEARS, ["p19", "p33"]),
    "observed": lambda m: m.load_observed_deployment(
        _path("observed_deployment_by_state_sector_2023.csv"), YEARS, STATES),
    "attachment": lambda m: m.load_attachment_rates(
        _path("ohm_attachment_rates.csv"), STATES),
    "vor": lambda m: m.load_value_of_resiliency(
        _path("value_of_resiliency", "vor_FY20_mid.csv"), STATES),
    "mms": lambda m: m.load_max_market_curves(_path("max_market_curves.csv")),
    "bass": lambda m: m.load_bass_params(_path("bass_params.csv"), STATES),
    "attachment_groups": lambda m: m.state_attachment_to_groups(
        m.load_attachment_rates(_path("ohm_attachment_rates.csv"), STATES)),
    "discover": lambda m: m.discover_reference_inputs(ROOT),
    "discover_prefer": lambda m: m.discover_reference_inputs(
        ROOT, prefer={"pv_prices": "ATB23", "load_growth": "experimental",
                      "elec_prices": "Mid_Case", "financing": "FY23"}),
    "discover_unmatched": lambda m: m.discover_reference_inputs(
        ROOT, prefer={"batt_prices": "no_such_file", "elec_prices": "nope"}),
    "read_csv": lambda m: m._read_csv(_path("itc_schedule.csv")),
}

RI_LOADERS = {
    "pv_plus_batt": lambda m: m.load_pv_plus_batt_prices(
        _path("pv_plus_batt_prices", "pv_plus_batt_prices_FY19_mid.csv"), YEARS),
    "starting_capacities": lambda m: m.load_starting_capacities(
        _path("installed_capacity_mw_by_state_sector.csv"), 2014, STATES),
    "starting_capacities_before_file": lambda m: m.load_starting_capacities(
        _path("installed_capacity_mw_by_state_sector.csv"), 2010, STATES),
    "wholesale": lambda m: m.load_wholesale(
        _path("wholesale_electricity_prices", "ATB23_Mid_Case_wholesale.csv"), YEARS, 2014),
    "wholesale_base": lambda m: m.load_wholesale_base(
        _path("wholesale_electricity_prices", "ATB19_Mid_Case_wholesale.csv"), 2017),
    "profile_bank_divisions": lambda m: m.wholesale_profile_bank(
        {"regions": list(m.CENSUS_DIVISIONS),
         "wholesale_base_usd_per_kwh": np.linspace(0.03, 0.05, 9, dtype=np.float32)},
        ROOT),
    "profile_bank_flat": lambda m: m.wholesale_profile_bank(
        {"regions": ["p1", "p10"],
         "wholesale_base_usd_per_kwh": np.asarray([0.031, 0.047], np.float32)}),
    "census": lambda m: (m.CENSUS_DIVISIONS, m.STATE_CENSUS_DIVISION),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_ingest_loader_equals_the_jax_package(name):
    _same_tree(LOADERS[name](ingest), LOADERS[name](jingest), name)


@pytest.mark.parametrize("name", sorted(RI_LOADERS))
def test_reference_inputs_loader_equals_the_jax_package(name):
    got, ref = RI_LOADERS[name](reference_inputs), RI_LOADERS[name](jri)
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same_tree(g, r, name)
    else:
        _same_tree(got, ref, name)


def test_fixture_reaches_the_branches():
    """The committed root exercises what it is there for: both picking
    rules, the preference over the default, the attachment average's two
    branches, Bass groups without a row, and both shape-file branches."""
    files = ingest.discover_reference_inputs(ROOT)
    # the first sorted match; with no preference the default substring is
    # not consulted (the first candidate is taken), as in the JAX package
    assert os.path.basename(files["batt_prices"]) == "batt_prices_FY19_high.csv"
    unmatched = ingest.discover_reference_inputs(ROOT, prefer={"batt_prices": "zzz"})
    assert os.path.basename(unmatched["batt_prices"]) == "batt_prices_FY19_mid.csv"
    rates = ingest.load_attachment_rates(_path("ohm_attachment_rates.csv"), STATES)
    assert rates[STATES.index("VT")] == 0.0
    assert 0 < rates[STATES.index("WY")] < 1 and 0 < rates[STATES.index("MT")] < 1
    assert ingest.load_bass_params(_path("bass_params.csv"), STATES)["missing"] > 0
    bank = reference_inputs.wholesale_profile_bank(
        {"regions": list(reference_inputs.CENSUS_DIVISIONS),
         "wholesale_base_usd_per_kwh": np.ones(9, np.float32)}, ROOT)
    cd = reference_inputs.CENSUS_DIVISIONS
    assert not np.array_equal(bank[cd.index("WSC")], bank[cd.index("NE")])
    assert not np.array_equal(bank[cd.index("PAC")], bank[cd.index("NE")])
    assert np.array_equal(bank[cd.index("NE")], bank[cd.index("MTN")])


def test_refusals_match(tmp_path):
    bad_deprec = tmp_path / "deprec.csv"
    bad_deprec.write_text("year,sector_abbr,1,2,3,4,5,6\n"
                          "2014,com,1.0,0.95,0.9,0.85,0.7,0.4\n")
    for mod in (ingest, jingest):
        with pytest.raises(ValueError, match="sum to"):
            mod.load_depreciation_schedules(str(bad_deprec), YEARS)
    rows = open(_path("max_market_curves.csv")).read().splitlines()
    no_ind = tmp_path / "mmc.csv"
    no_ind.write_text("\n".join(r for r in rows if ",ind," not in r) + "\n")
    for mod in (ingest, jingest):
        with pytest.raises(ValueError, match="no host_owned payback_period rows"):
            mod.load_max_market_curves(str(no_ind))
    short = tmp_path / "shape" / "wholesale_hourly_shape.csv"
    short.parent.mkdir()
    short.write_text("shape\n1.0\n2.0\n")
    meta = {"regions": ["NE"], "wholesale_base_usd_per_kwh": np.ones(1, np.float32)}
    for mod in (reference_inputs, jri):
        with pytest.raises(ValueError, match="8760"):
            mod.wholesale_profile_bank(meta, str(short.parent))
    cfg = tcfg.ScenarioConfig(name="t", start_year=2014, end_year=2016)
    with pytest.raises(ValueError, match="unknown region_kind"):
        reference_inputs.scenario_inputs_from_reference(ROOT, cfg, STATES,
                                                        region_kind="county",
                                                        device="cpu")


# ---------------------------------------------------------------------------
# tests/test_ingest_curves.py:22-122, replayed against the port
# ---------------------------------------------------------------------------

def _write_mmc(path):
    rows = ["metric_value,sector_abbr,max_market_share,metric,business_model"]
    for sec, scale in (("res", 1.0), ("com", 0.8), ("ind", 0.6)):
        for pb in range(0, 31):
            share = scale * max(0.0, 1.0 - pb / 30.0)
            rows.append(f"{pb},{sec},{share},payback_period,host_owned")
        rows.append(f"5,{sec},0.99,percent_monthly_bill_savings,host_owned")
        rows.append(f"5,{sec},0.99,payback_period,tpo")
    path.write_text("\n".join(rows) + "\n")


def test_uniform_mms_sentinel_is_zero():
    from dgen_tpu_torch.models.scenario import uniform_inputs

    cfg = tcfg.ScenarioConfig(name="t", start_year=2020, end_year=2024)
    mms = uniform_inputs(cfg, n_groups=6, n_regions=2, device="cpu").mms_table.numpy()
    assert mms.shape[1] == tcfg.PAYBACK_GRID_N
    np.testing.assert_array_equal(mms[:, -1], 0.0)
    assert mms[:, 0].min() > 0.5


def test_load_max_market_curves(tmp_path):
    p = tmp_path / "max_market_curves.csv"
    _write_mmc(p)
    mms = ingest.load_max_market_curves(str(p))
    _same(mms, jingest.load_max_market_curves(str(p)))
    assert mms.shape == (3, tcfg.PAYBACK_GRID_N)
    assert mms[0, 45] == pytest.approx(1.0 - 4.5 / 30.0, abs=1e-6)
    assert mms[0, 50] == pytest.approx(1.0 - 5.0 / 30.0, abs=1e-6)
    assert mms[1, 0] == pytest.approx(0.8, abs=1e-6)
    np.testing.assert_array_equal(mms[:, -1], 0.0)


def test_load_bass_params(tmp_path):
    p = tmp_path / "bass_params.csv"
    p.write_text("state_abbr,p,q,teq_yr1,sector_abbr,tech\n"
                 "CA,0.003,0.5,3.0,res,solar\nCA,0.001,0.4,1.0,com,solar\n"
                 "CA,0.009,0.9,9.0,res,wind\n")
    out = ingest.load_bass_params(str(p), ["CA", "TX"])
    _same_tree(out, jingest.load_bass_params(str(p), ["CA", "TX"]))
    assert out["bass_p"][0] == pytest.approx(0.003)
    assert out["bass_q"][0] == pytest.approx(0.5)
    assert out["teq_yr1"][1] == pytest.approx(1.0)
    assert out["bass_p"][3] == pytest.approx(0.0015)
    assert out["missing"] == 4


def test_load_value_of_resiliency(tmp_path):
    p = tmp_path / "vor.csv"
    p.write_text("state_abbr,sector_abbr,value_of_resiliency_usd\n"
                 "AL,com,2763.27\nAL,ind,57996.42\n")
    vor = ingest.load_value_of_resiliency(str(p), ["AL", "AK"])
    _same(vor, jingest.load_value_of_resiliency(str(p), ["AL", "AK"]))
    assert vor[1] == pytest.approx(2763.27) and vor[2] == pytest.approx(57996.42)
    assert vor[0] == 0.0 and vor[3] == 0.0


def test_scenario_wiring_dropins(tmp_path):
    root = tmp_path / "input_data"
    root.mkdir()
    _write_mmc(root / "max_market_curves.csv")
    (root / "bass_params.csv").write_text(
        "state_abbr,p,q,teq_yr1,sector_abbr\nCA,0.002,0.45,2.5,res\n")
    vdir = root / "value_of_resiliency"
    vdir.mkdir()
    (vdir / "vor.csv").write_text(
        "state_abbr,sector_abbr,value_of_resiliency_usd\nCA,com,1000.0\n")
    cfg = tcfg.ScenarioConfig(name="t", start_year=2020, end_year=2024)
    inputs, meta = reference_inputs.scenario_inputs_from_reference(
        str(root), cfg, ["CA", "TX"], device="cpu")
    assert meta["market_curves"] == {"mms": "ingested", "bass": "ingested"}
    assert float(inputs.bass_p[0]) == pytest.approx(0.002)
    assert float(inputs.mms_table[1, 0]) == pytest.approx(0.8)
    assert tuple(inputs.value_of_resiliency.shape) == (len(cfg.model_years), 6)
    assert float(inputs.value_of_resiliency[0, 1]) == 1000.0
    bare = tmp_path / "bare"
    bare.mkdir()
    _, meta2 = reference_inputs.scenario_inputs_from_reference(
        str(bare), cfg, ["CA", "TX"], device="cpu")
    assert meta2["market_curves"] == {"mms": "synthetic_default",
                                      "bass": "synthetic_default"}
    assert meta2["data_sources"] == {"itc": "federal_statute_default",
                                     "nem_caps": "uncapped_default"}


# ---------------------------------------------------------------------------
# ScenarioInputs on five roots, field by field
# ---------------------------------------------------------------------------

def _bare_root(tmp_path) -> str:
    """A copy of the committed root without the optional families and the
    drop-ins (no ITC, NEM, market curves, Bass, VOR, carbon, combined
    prices, shape file, installed capacity)."""
    d = tmp_path / "bare" / "dgen_os"
    shutil.copytree(os.path.join(FIXTURE, "dgen_os", "input_data"), d / "input_data")
    root = d / "input_data"
    for sub in ("value_of_resiliency", "carbon_intensities", "pv_plus_batt_prices"):
        shutil.rmtree(root / sub)
    for name in ("itc_schedule.csv", "nem_state_limits.csv", "max_market_curves.csv",
                 "bass_params.csv", "wholesale_hourly_shape.csv",
                 "installed_capacity_mw_by_state_sector.csv"):
        os.remove(root / name)
    return str(root)


ROOTS = ("committed", "ba", "bare", "workbook_prefer", "overrides")


def _root_case(case, tmp_path):
    kw = {}
    root = ROOT
    if case == "ba":
        kw["region_kind"] = "ba"
    elif case == "bare":
        root = _bare_root(tmp_path)
    elif case == "workbook_prefer":
        kw["prefer"] = workbook.scenario_from_workbook(XLSM)[1]["prefer"]
    elif case == "overrides":
        kw["overrides"] = {"attachment_rate": np.full(len(STATES) * 3, 0.25, np.float32),
                           "itc_fraction": np.full((len(YEARS), 3), 0.1, np.float32)}
    return root, kw


@pytest.mark.parametrize("case", ROOTS)
def test_scenario_inputs_equal_the_jax_package(case, tmp_path):
    root, kw = _root_case(case, tmp_path)
    tc = tcfg.ScenarioConfig(name="t", start_year=2014, end_year=2050, anchor_years=())
    jc = jcfg.ScenarioConfig(name="t", start_year=2014, end_year=2050, anchor_years=())
    got, gmeta = reference_inputs.scenario_inputs_from_reference(root, tc, STATES,
                                                                 device="cpu", **kw)
    ref, rmeta = jri.scenario_inputs_from_reference(root, jc, STATES, **kw)
    for f in dataclasses.fields(got):
        _same(getattr(got, f.name).numpy(), np.asarray(getattr(ref, f.name)), f.name)
    assert set(gmeta) == set(rmeta)
    for k in rmeta:
        _same_tree(gmeta[k], rmeta[k], k)
    if case == "bare":
        assert gmeta["data_sources"] == {"itc": "federal_statute_default",
                                         "nem_caps": "uncapped_default"}
    else:
        assert gmeta["data_sources"] == {"itc": "ingested", "nem_caps": "ingested"}
        assert gmeta["market_curves"] == {"mms": "ingested", "bass": "ingested"}
    if case == "ba":
        assert gmeta["regions"] == gmeta["bas"] and len(gmeta["regions"]) == 12


def test_workbook_prefer_picks_its_files():
    prefer = workbook.scenario_from_workbook(XLSM)[1]["prefer"]
    cfg = tcfg.ScenarioConfig(name="t", start_year=2014, end_year=2016)
    _, meta = reference_inputs.scenario_inputs_from_reference(ROOT, cfg, STATES,
                                                              prefer=prefer, device="cpu")
    files = {k: os.path.basename(v) for k, v in meta["files"].items()}
    assert files["pv_prices"] == "pv_price_atb23_mid.csv"
    assert files["financing"] == "financing_atb_FY23.csv"
    assert files["load_growth"] == "Experimental_high_electrification.csv"
    assert files["elec_prices"] == "ATB19_High_Case_retail.csv"
    assert meta["bas"][0] == "p1"


# ---------------------------------------------------------------------------
# the NEM caps: CSV rows against the JAX package's pandas compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_mult", [False, True], ids=["flat", "res_load_multiplier"])
def test_nem_caps_from_rows_equal_the_jax_package(with_mult):
    paths = (_path("nem_state_limits.csv"), os.path.join(PYDIR, "peak_demand_mw.csv"),
             os.path.join(PYDIR, "cf_during_peak_demand.csv"))
    frames = [pd.read_csv(p) for p in paths]
    limits = frames[0]
    # the fixture's table carries a blank window and a non-numeric cell
    assert limits["first_year"].isna().any() and limits["sunset_year"].isna().any()
    assert pd.to_numeric(limits["max_pct_cum_capacity"], errors="coerce").isna().sum() > \
        limits["max_pct_cum_capacity"].isna().sum()
    mult = (np.linspace(1.0, 1.4, len(YEARS) * len(STATES), dtype=np.float32)
            .reshape(len(YEARS), len(STATES)) if with_mult else None)
    ref = jnem.compile_state_nem_caps(*frames, YEARS, STATES, mult)
    got = nem.compile_state_nem_caps_rows(*[ingest._read_csv(p) for p in paths],
                                          YEARS, STATES, mult)
    _same(got, ref)
    _same(nem.compile_state_nem_caps(*frames, YEARS, STATES, mult), ref)
    tx, ca = STATES.index("TX"), STATES.index("CA")
    assert got[0, tx] == nem.NO_CAP and got[1, tx] < nem.NO_CAP    # opens in 2016
    assert got[2, ca] < nem.NO_CAP and got[3, ca] == nem.NO_CAP    # sunset 2018


def test_nem_cell_parsing_follows_pandas():
    cells = ["", "NA", "n/a", "nan", "12.5", " 7 ", "1e3", "abc", "1_000", None, 4, 2.5]
    got = [nem._num_cell(c) for c in cells]
    ref = pd.to_numeric(pd.Series(
        [np.nan if c is None or str(c).strip() in nem._NA_CELLS else c for c in cells],
        dtype=object).map(lambda v: v.strip() if isinstance(v, str) else v),
        errors="coerce").tolist()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref, dtype=float))


# ---------------------------------------------------------------------------
# store.csv_to_bank (tests/test_store.py:33-85, and bit for bit)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(7)
    return (rng.random((257, 123)) * 100.0 - 20.0).astype(np.float32)


def _write_repr(path, values, ids=None, header=None):
    with open(path, "w") as f:
        if header:
            f.write(",".join(header) + "\n")
        for i, row in enumerate(values):
            cells = [repr(float(v)) for v in row]
            if ids is not None:
                cells = [ids[i]] + cells
            f.write(",".join(cells) + "\n")


@pytest.mark.parametrize("ids", [False, True], ids=["no_ids", "id_columns"])
def test_csv_to_bank_equals_the_jax_package(tmp_path, ids):
    rng = np.random.default_rng(19)
    values = rng.normal(0.0, 1e3, (64, 40)) * 10.0 ** rng.integers(-6, 3, (64, 40))
    p = str(tmp_path / "m.csv")
    _write_repr(p, values, ids=[f"bldg_{i},{i}" for i in range(64)] if ids else None)
    skip = 2 if ids else 0
    got = store.csv_to_bank(p, bank_path=str(tmp_path / "t.dgpb"), skip_header=False,
                            skip_cols=skip)
    ref = jstore.csv_to_bank(p, bank_path=str(tmp_path / "j.dgpb"), skip_header=False,
                             skip_cols=skip)
    _same(got, ref)
    assert filecmp.cmp(str(tmp_path / "t.dgpb"), str(tmp_path / "j.dgpb"), shallow=False)
    _same(store.read_bank(str(tmp_path / "t.dgpb")).numpy(), ref)


def test_csv_parse_matches_numpy(tmp_path, matrix):
    p = str(tmp_path / "m.csv")
    np.savetxt(p, matrix, delimiter=",",
               header=",".join(f"c{i}" for i in range(matrix.shape[1])),
               comments="", fmt="%.7g")
    got = store.csv_to_bank(p)
    ref = np.loadtxt(p, delimiter=",", skiprows=1, dtype=np.float32, ndmin=2)
    assert got.shape == matrix.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    _same(got, jstore.csv_to_bank(p))


def test_csv_skip_cols(tmp_path):
    p = str(tmp_path / "ids.csv")
    with open(p, "w") as f:
        f.write("id,a,b\n101,1.5,2.5\n102,3.5,4.5\n")
    got = store.csv_to_bank(p, skip_cols=1)
    np.testing.assert_allclose(got, [[1.5, 2.5], [3.5, 4.5]])
    _same(got, jstore.csv_to_bank(p, skip_cols=1))


def test_csv_to_bank_persists(tmp_path, matrix):
    csvp, bankp = str(tmp_path / "m.csv"), str(tmp_path / "m.dgpb")
    np.savetxt(csvp, matrix, delimiter=",", comments="", fmt="%.7g")
    got = store.csv_to_bank(csvp, bank_path=bankp, skip_header=False)
    np.testing.assert_allclose(store.read_bank(bankp).numpy(), got)


@pytest.mark.parametrize("skip_cols", [0, 1])
def test_csv_short_row_rejected(tmp_path, skip_cols):
    p = str(tmp_path / "short.csv")
    with open(p, "w") as f:
        f.write("a,b,c\n1.0,2.0,3.0\n4.0,5.0\n6.0,7.0,8.0\n")
    with pytest.raises(IOError):
        store.csv_to_bank(p, skip_cols=skip_cols)
    if jstore.bank_available():
        with pytest.raises(IOError):
            jstore.csv_to_bank(p, skip_cols=skip_cols)


def test_fallback_skip_cols_with_string_ids(tmp_path):
    p = str(tmp_path / "ids.csv")
    with open(p, "w") as f:
        f.write("id,a,b\nbldg_001,1.5,2.5\nbldg_002,3.5,4.5\n")
    np.testing.assert_allclose(store.csv_to_bank(p, skip_cols=1), [[1.5, 2.5], [3.5, 4.5]])
    with pytest.raises(ValueError, match="no data columns"):
        store.csv_to_bank(p, skip_cols=3)


# ---------------------------------------------------------------------------
# the scenario workbook
# ---------------------------------------------------------------------------

def test_workbook_reads_equal_the_jax_package():
    got, ref = workbook.read_scenario(XLSM), jwb.read_scenario(XLSM)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.name, got.end_year, got.storage_enabled, got.region, got.markets,
            got.seed) == ("ercot fixture", 2030, True, "ERCOT", "All", 7)
    assert got.selections == {
        "load_growth": "Experimental", "financing": "financing_atb_FY23",
        "pv_prices": "pv_price_atb23_mid", "elec_prices": "ATB19_High_Case_retail",
        "wholesale": "ATB19_Mid_Case_wholesale"}
    assert got.agent_file == "agent_df_base_ercot"
    assert workbook.read_named_ranges(XLSM) == jwb.read_named_ranges(XLSM)
    cfg, info = workbook.scenario_from_workbook(XLSM)
    jcfg_, jinfo = jwb.scenario_from_workbook(XLSM)
    assert info == jinfo and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_)
    assert isinstance(cfg, tcfg.ScenarioConfig) and info["states"] == ["TX"]


def test_export_drop_ins_write_the_same_files(tmp_path):
    got = workbook.export_drop_ins(XLSM, str(tmp_path / "t"))
    ref = jwb.export_drop_ins(XLSM, str(tmp_path / "j"))
    assert {k: os.path.basename(v) for k, v in got.items()} == \
        {k: os.path.basename(v) for k, v in ref.items()}
    assert "wholesale_elec_prices_user_defined" in got
    for k in ref:
        assert filecmp.cmp(got[k], ref[k], shallow=False), k


@pytest.mark.parametrize("region,want", [
    ("National", None), ("Delaware", ["DE"]), ("ERCOT", ["TX"]), ("TX", ["TX"]),
    ("iso-ne", ["CT", "MA", "ME", "NH", "RI", "VT"])])
def test_region_resolution(region, want):
    assert workbook.resolve_states(region) == jwb.resolve_states(region) == want


def test_region_and_market_refusals_and_weights():
    for mod in (workbook, jwb):
        with pytest.raises(ValueError):
            mod.resolve_states("Atlantis")
    for markets, want in (("Only Commercial", (0.0, 1.0, 0.0)), ("All", (0.7, 0.2, 0.1)),
                          ("Only Residential", (1.0, 0.0, 0.0)),
                          ("only industrial", (0.0, 0.0, 1.0))):
        assert workbook.resolve_sector_weights(markets) == \
            jwb.resolve_sector_weights(markets) == want


# ---------------------------------------------------------------------------
# the ingest fault site, and the generator
# ---------------------------------------------------------------------------

def test_ingest_fault_is_transient_and_retryable(tmp_path):
    p = str(tmp_path / "t.csv")
    with open(p, "w") as f:
        f.write("year,v_res,v_com,v_ind\n2014,1,2,3\n")
    assert "ingest" in faults.SITES and "ingest" not in faults.UNPORTED_SITES
    with faults.injected("ingest@1") as reg:
        with pytest.raises(faults.FaultError) as ei:
            ingest._read_csv(p)
        assert classify_error(ei.value) == TRANSIENT
        rows = ingest._read_csv(p)
    assert reg.fired("ingest") == 1 and rows[0]["year"] == "2014"


def test_generator_reproduces_the_committed_files(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_reference_inputs", os.path.join(FIXTURE, "make_reference_inputs.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.generate(str(tmp_path))
    made = sorted(os.path.relpath(os.path.join(d, n), tmp_path)
                  for d, _, names in os.walk(tmp_path) for n in names)
    committed = sorted(os.path.relpath(os.path.join(d, n), FIXTURE)
                       for d, _, names in os.walk(os.path.join(FIXTURE, "dgen_os"))
                       for n in names)
    assert made == committed
    for rel in made:
        assert filecmp.cmp(os.path.join(tmp_path, rel), os.path.join(FIXTURE, rel),
                           shallow=False), rel
    size = sum(os.path.getsize(os.path.join(FIXTURE, rel)) for rel in committed)
    assert size < 2 * 2**20
