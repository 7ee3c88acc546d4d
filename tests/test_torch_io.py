"""The port's data plane against the JAX package's, on the CPU: the DGPB1
bank store (files byte for byte, and each side reading the other's), the
package loader (a JAX package's parquet and the port's own npz, f32, bf16
and int8 banks), the reference-pickle converter on the golden fixture,
the committed port-format golden package, and the tariff-dict parser, the
bad-tariff reassignment and the NEM policy resolution case by case."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dgen_tpu.io import convert as jconvert
from dgen_tpu.io import nem as jnem
from dgen_tpu.io import package as jpackage
from dgen_tpu.io import store as jstore
from dgen_tpu.io import synth as jsynth
from dgen_tpu_torch.convert import to_numpy_dict
from dgen_tpu_torch.io import convert, nem, package, store, synth
from dgen_tpu_torch.tools import make_golden_package

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS, "fixtures")
GOLDEN_PKG = os.path.join(TESTS, "torch_fixtures", "golden_pkg")
BANKS = ("load_profiles.dgpb", "solar_cf.dgpb", "wholesale.dgpb")


def _bits(a) -> np.ndarray:
    """The stored bytes of a host array or CPU tensor (bfloat16 as its
    16-bit patterns)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.uint16) if str(a.dtype) == "bfloat16" else a).view(np.uint8)


def _dtype(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _same(port, ref, path="") -> None:
    """Field for field: every field of ``ref`` is in ``port``, integers
    exact and floats bitwise, at the same dtype and shape."""
    if isinstance(ref, dict):
        extra = {k for k, v in ref.items() if v is not None} - set(port)
        assert not extra, f"{path}: the port lacks {sorted(extra)}"
        for k, v in ref.items():
            if v is not None:
                _same(port[k], v, f"{path}.{k}")
    elif isinstance(ref, (int, float, str, list)):
        assert port == ref, (path, port, ref)
    else:
        ref = np.asarray(ref)
        assert _dtype(port) == _dtype(ref), (path, port.dtype, ref.dtype)
        assert tuple(port.shape) == ref.shape, (path, port.shape, ref.shape)
        assert np.array_equal(_bits(port), _bits(ref)), f"{path} differs"


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_population(port, ref) -> None:
    for f in ("table", "tariffs"):
        _same(to_numpy_dict(getattr(port, f)), to_numpy_dict(getattr(ref, f)), f)
    # bank by bank: a bfloat16 bank has no numpy dtype on the port's side
    _same(_fields(port.profiles), _fields(ref.profiles), "profiles")
    assert port.states == ref.states
    assert json.loads(json.dumps(port.tariff_specs)) == json.loads(
        json.dumps(ref.tariff_specs))


# ---------------------------------------------------------------------------
# the DGPB1 store
# ---------------------------------------------------------------------------

def _bank_data(seed: int) -> np.ndarray:
    """[7, 300] float32 profile-like rows, one all zero, and float32 values
    exactly halfway between two bfloat16 values (round to nearest even)."""
    x = np.random.default_rng(seed).gamma(2.0, 0.3, (7, 300)).astype(np.float32)
    x[3] = 0.0
    ties = (np.arange(16, dtype=np.uint32) << 16) | 0x3F808000
    x[5, :16] = ties.view(np.float32)
    x[6] *= -1.0
    return x


@pytest.mark.parametrize("dtype", [None, "f32", "bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_files_are_the_jax_packages(tmp_path, dtype, seed):
    """The port writes the JAX package's bytes; each side's raw reader
    gives the other's file bit for bit, and read_bank dequantizes int8
    as the JAX package does."""
    data = _bank_data(seed)
    mine, theirs = str(tmp_path / "port.dgpb"), str(tmp_path / "jax.dgpb")
    store.write_bank(mine, torch.from_numpy(data), dtype=dtype)
    jstore.write_bank(theirs, data, dtype=dtype)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        got, got_scales = store.read_bank_raw(path)
        ref, ref_scales = jstore.read_bank_raw(path)
        assert got.shape == ref.shape
        assert np.array_equal(_bits(got), _bits(ref))
        assert (got_scales is None) == (ref_scales is None)
        if ref_scales is not None:
            assert np.array_equal(got_scales.numpy(), ref_scales)
        assert np.array_equal(_bits(store.read_bank(path)),
                              _bits(jstore.read_bank(path)))
    expect = {None: torch.float32, "f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}[dtype]
    assert store.read_bank_raw(mine)[0].dtype == expect


def test_store_bf16_rounds_ties_to_even(tmp_path):
    data = _bank_data(0)
    path = str(tmp_path / "b.dgpb")
    store.write_bank(path, data, dtype="bf16")
    got = store.read_bank_raw(path)[0][5, :16].view(torch.int16).numpy().view(np.uint16)
    hi = (data[5, :16].view(np.uint32) >> 16).astype(np.uint16)
    # halfway: round to the even neighbour
    assert np.array_equal(got, hi + (hi & 1))


def test_store_int8_codes_with_scales_and_refusals(tmp_path):
    data = _bank_data(2)
    codes, scales = _jax_quantize(data)
    mine, theirs = str(tmp_path / "p.dgpb"), str(tmp_path / "j.dgpb")
    store.write_bank(mine, codes, scales=scales)
    jstore.write_bank(theirs, codes, scales=scales)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="scales"):
        store.write_bank(mine, codes)
    with pytest.raises(ValueError, match="scales only apply"):
        store.write_bank(mine, data, scales=scales)
    with pytest.raises(ValueError, match="2-D"):
        store.write_bank(mine, data[0])
    with pytest.raises(ValueError, match="unsupported bank dtype"):
        store.write_bank(mine, data, dtype="f16")
    with open(mine, "r+b") as f:
        f.write(b"XGPB1\x00")
    with pytest.raises(IOError, match="magic"):
        store.read_bank_raw(mine)
    with open(theirs, "rb") as f:
        blob = f.read()
    with open(mine, "wb") as f:
        f.write(blob[:-3])
    with pytest.raises(IOError, match="truncated"):
        store.read_bank_raw(mine)


def _jax_quantize(data):
    from dgen_tpu.models.agents import quantize_rows

    return quantize_rows(data)


def test_store_never_touches_the_native_library():
    """The port's store imports numpy and torch alone: no ctypes (the JAX
    package's native reader), no compiler call, no ml_dtypes."""
    import ast

    with open(store.__file__) as f:
        tree = ast.parse(f.read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"__future__", "os", "typing", "numpy", "torch", "dgen_tpu_torch"}
    assert not any(isinstance(n, ast.Constant) and ("libdgen_native" in str(n.value)
                                                    or "profile_store" in str(n.value))
                   for n in ast.walk(tree))


# ---------------------------------------------------------------------------
# the package loader
# ---------------------------------------------------------------------------

def _jax_population(bank: str):
    pop = jsynth.generate_population(40, states=["DE", "CA"], seed=3,
                                     pad_multiple=8, rate_switch_frac=0.5)
    profiles = pop.profiles
    if bank == "bf16":
        profiles = dataclasses.replace(
            profiles, load=profiles.load.astype(jnp.bfloat16),
            solar_cf=profiles.solar_cf.astype(jnp.bfloat16),
            wholesale=profiles.wholesale.astype(jnp.bfloat16))
    return pop.table, profiles, _specs()


def _specs():
    from dgen_tpu.io.synth import make_tariff_specs

    return make_tariff_specs()


def _port_population(bank: str):
    pop = synth.generate_population(40, states=["DE", "CA"], seed=3,
                                    pad_multiple=8, rate_switch_frac=0.5,
                                    device="cpu")
    profiles = pop.profiles
    if bank == "bf16":
        profiles = dataclasses.replace(
            profiles, load=profiles.load.to(torch.bfloat16),
            solar_cf=profiles.solar_cf.to(torch.bfloat16),
            wholesale=profiles.wholesale.to(torch.bfloat16))
    return pop.table, profiles, _specs()


@pytest.mark.parametrize("bank", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax_parquet", "port_npz"])
def test_load_population_matches_the_jax_loader(tmp_path, writer, bank):
    """A package loads through the port as the JAX loader loads the JAX
    package's own package of the same population: integers exact, floats
    bitwise, a bf16 bank as bfloat16, an int8 bank dequantized."""
    ref_dir, pkg_dir = str(tmp_path / "jax"), str(tmp_path / "pkg")
    quant = bank == "int8"
    table, profiles, specs = _jax_population(bank)
    jpackage.save_population(ref_dir, table, profiles, specs, ["DE", "CA"],
                             quant_banks=quant)
    ref = jpackage.load_population(ref_dir, pad_multiple=16)
    if writer == "jax_parquet":
        pkg_dir = ref_dir
    else:
        table, profiles, specs = _port_population(bank)
        package.save_population(pkg_dir, table, profiles, specs, ["DE", "CA"],
                                quant_banks=quant)
        assert sorted(os.listdir(pkg_dir)) == sorted(
            ["agents.npz", "meta.json", "tariffs.json", *BANKS])
        for name in BANKS + ("meta.json",):
            with open(os.path.join(pkg_dir, name), "rb") as a, \
                    open(os.path.join(ref_dir, name), "rb") as b:
                assert a.read() == b.read(), name
    got = package.load_population(pkg_dir, pad_multiple=16, device="cpu")
    _same_population(got, ref)
    assert got.profiles.load.dtype == (torch.bfloat16 if bank == "bf16"
                                       else torch.float32)
    assert got.table.n_agents == 48 and int(got.table.mask.sum()) == 40


def test_load_population_refuses_bad_packages(tmp_path):
    table, profiles, specs = _port_population("f32")
    package.save_population(str(tmp_path), table, profiles, specs, ["DE", "CA"])
    os.remove(tmp_path / "agents.npz")
    with pytest.raises(FileNotFoundError, match="agents.npz"):
        package.load_population(str(tmp_path), device="cpu")
    with open(tmp_path / "meta.json", "w") as f:
        json.dump({"format_version": 2}, f)
    with pytest.raises(ValueError, match="package format"):
        package.load_population(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# the reference-pickle converter and the committed golden package
# ---------------------------------------------------------------------------

def _golden_args():
    return (
        (pd.read_pickle(os.path.join(FIXTURES, "golden_load_profiles.pkl")),
         pd.read_pickle(os.path.join(FIXTURES, "golden_solar_profiles.pkl"))),
        dict(wholesale_by_region={"SA": np.full(8760, 0.03)},
             state_incentives=pd.read_csv(os.path.join(FIXTURES, "golden_incentives.csv")),
             nem_state_by_sector=pd.read_csv(os.path.join(FIXTURES, "golden_state_nem.csv")),
             nem_utility_by_sector=pd.read_csv(os.path.join(FIXTURES, "golden_util_nem.csv"))),
    )


@pytest.fixture(scope="module")
def golden_conversions(tmp_path_factory):
    (load_df, cf_df), kw = _golden_args()
    frame = os.path.join(FIXTURES, "golden_agents.pkl")
    base = tmp_path_factory.mktemp("conv")
    ref = jconvert.from_reference_pickle(pd.read_pickle(frame), str(base / "jax"),
                                         load_df, cf_df, **kw)
    got = convert.from_reference_pickle(pd.read_pickle(frame), str(base / "port"),
                                        load_df, cf_df, device="cpu", **kw)
    return base, got, ref


def test_converter_matches_the_jax_converter(golden_conversions):
    """Table (incentive slots and NEM fields included), banks, the
    compiled tariffs and the specs after a JSON round trip equal the JAX
    converter's; so do the packages each writes."""
    base, got, ref = golden_conversions
    _same_population(got, ref)
    assert float(got.table.incentives.cbi_usd_p_w.abs().sum()) > 0
    assert float((got.table.nem_kw_limit < 1e30).sum()) > 0
    for name in BANKS + ("tariffs.json", "meta.json"):
        with open(base / "port" / name, "rb") as a, open(base / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    frame = pd.read_parquet(base / "jax" / "agents.parquet")
    with np.load(base / "port" / "agents.npz") as z:
        assert sorted(z.files) == sorted(frame.columns)
        for c in frame.columns:
            _same(z[c], frame[c].to_numpy(), c)


def test_converted_package_loads_as_the_jax_loader_loads_it(golden_conversions):
    base, _, _ = golden_conversions
    ref = jpackage.load_population(str(base / "jax"), pad_multiple=32)
    for d in ("jax", "port"):
        _same_population(package.load_population(str(base / d), pad_multiple=32,
                                                 device="cpu"), ref)


def test_committed_golden_package_is_what_the_converter_makes(tmp_path):
    out = str(tmp_path / "golden_pkg")
    make_golden_package.make(out)
    assert sorted(os.listdir(out)) == sorted(os.listdir(GOLDEN_PKG))
    for name in BANKS + ("tariffs.json", "meta.json"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(GOLDEN_PKG, name), "rb") as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(out, "agents.npz")) as a, \
            np.load(os.path.join(GOLDEN_PKG, "agents.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for c in a.files:
            _same(a[c], b[c], c)


# ---------------------------------------------------------------------------
# the converter's pieces, case by case
# ---------------------------------------------------------------------------

TARIFF_CELLS = {
    "dict": {"ur_metering_option": 0, "e_prices": [[0.1, 0.2]]},
    "json": '{"ur_metering_option": 1, "e_prices": [[0.12]], "fixed_charge": 9}',
    "quoted_nan": "{'ur_metering_option': nan, 'e_prices': [[0.1]], 'd_flat_prices': None}",
    "literal": "{'e_prices': [[0.1]], 'fixed_charge': 5, 'note': (1, 2)}",
    "list_literal": "[1, 2, 3]",
    "garbage": "{not a dict",
    "number": 3.5,
    "none": None,
}


@pytest.mark.parametrize("case", sorted(TARIFF_CELLS))
def test_parse_tariff_dict_matches(case):
    raw = TARIFF_CELLS[case]
    got = convert.parse_tariff_dict(raw)
    assert got == jconvert.parse_tariff_dict(raw)
    if not isinstance(got, dict):
        return  # a JSON list parses as itself on both sides
    assert convert.reference_tariff_to_spec(got) == jconvert.reference_tariff_to_spec(got)
    assert convert.reference_tariff_to_demand_spec(got) == \
        jconvert.reference_tariff_to_demand_spec(got)


def _tariff_frame(case: str) -> pd.DataFrame:
    rows = [("DE", "res", 1, "a"), ("DE", "res", 1, "a"), ("DE", "res", 2, "b"),
            ("DE", "com", 3, "c"), ("MD", "res", 4, "d"), ("MD", "com", 3, "c")]
    if case == "state_sector":
        rows.append(("DE", "res", 4145, "bad"))
    elif case == "sector":
        rows.append(("VA", "com", 7111, "bad"))
    elif case == "any":
        rows.append(("VA", "ind", 12003, "bad"))
    elif case == "all_bad":
        rows = [("DE", "res", 4145, "bad"), ("MD", "com", 8498, "bad")]
    return pd.DataFrame(rows, columns=["state_abbr", "sector_abbr", "tariff_id",
                                       "tariff_dict"])


@pytest.mark.parametrize("case", ["none_bad", "state_sector", "sector", "any", "all_bad"])
def test_reassign_bad_tariffs_matches(case):
    if case == "all_bad":
        for fn in (convert.reassign_bad_tariffs, jconvert.reassign_bad_tariffs):
            with pytest.raises(ValueError, match="every agent"):
                fn(_tariff_frame(case))
        return
    got = convert.reassign_bad_tariffs(_tariff_frame(case))
    pd.testing.assert_frame_equal(got, jconvert.reassign_bad_tariffs(_tariff_frame(case)))
    assert not got["tariff_id"].isin(convert.BAD_TARIFF_IDS).any()


NEM_STATE = pd.DataFrame({
    "state_abbr": ["DE", "DE", "MD", "MD", "VA"],
    "sector_abbr": ["res", "com", "res", "res", "res"],
    "nem_system_kw_limit": [25.0, 100.0, 20.0, 999.0, np.nan],
    "first_year": [2010, np.nan, 2015, 2000, 2014],
    "sunset_year": [2030, 2040, np.nan, 2001, 2020],
})
NEM_UTIL = pd.DataFrame({
    "eia_id": [1234, 5678, 1234],
    "sector_abbr": ["res", "com", "res"],
    "state_abbr": ["DE", "DE", "DE"],
    "nem_system_kw_limit": [50.0, 0.0, 7.0],
    "first_year": [2012, 2016, 2012],
    "sunset_year": [np.nan, 2025, 2030],
})
NEM_CASES = {
    "state_only": (NEM_STATE, None, None),
    "utility_override": (NEM_STATE, NEM_UTIL, ["1234", "5678", "1234.0", "99", "x", "1234"]),
    "float_ids": (NEM_STATE, NEM_UTIL, [1234.0, 5678.0, np.nan, 1.0, 2.0, 1234.0]),
    "no_tables": (None, None, None),
}


@pytest.mark.parametrize("case", sorted(NEM_CASES))
def test_resolve_agent_nem_policy_matches(case):
    by_state, by_util, eia = NEM_CASES[case]
    args = dict(agent_state=["DE", "DE", "DE", "MD", "VA", "TX"],
                agent_sector=["res", "com", "res", "res", "res", "res"],
                agent_eia_id=eia)
    got = nem.resolve_agent_nem_policy(by_state, by_util, **args)
    ref = jnem.resolve_agent_nem_policy(by_state, by_util, **args)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _same(got[k], ref[k], k)


def test_compile_state_nem_caps_matches():
    limits = pd.DataFrame({"state_abbr": ["DE", "MD", "VA"],
                           "max_cum_capacity_mw": [50.0, np.nan, 10.0],
                           "max_pct_cum_capacity": [5.0, 2.5, np.nan],
                           "first_year": [2014, np.nan, 2016],
                           "sunset_year": [2030, 2022, np.nan]})
    peak = pd.DataFrame({"state_abbr": ["DE", "MD"], "peak_demand_mw_2014": [2500.0, 6000.0]})
    cf = pd.DataFrame({"state_abbr": ["DE", "MD"],
                       "solar_cf_during_peak_demand_period": [0.45, 0.0]})
    years, states = [2014, 2016, 2024, 2032], ["DE", "MD", "VA", "TX"]
    mult = np.linspace(1.0, 1.3, 16, dtype=np.float32).reshape(4, 4)
    for m in (None, mult):
        _same(nem.compile_state_nem_caps(limits, peak, cf, years, states, m),
              jnem.compile_state_nem_caps(limits, peak, cf, years, states, m))
