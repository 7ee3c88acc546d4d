"""The engine-free serving layers of the PyTorch port against its own
engine and the JAX package's formats (tests/test_serve_surface.py:81-280):
the memory-mapped table (round trip, truncation and tamper checks, and
each package reading the other's tables), the answer surface (bit for bit
against the engine at its build bucket, a stale or damaged surface
refused with a named reason and the engine answering in its place, the
``surface_load`` fault site), the batcher's fast path, the exact result
cache (hits bit for bit, shared by two engines, partitioned by
provenance, LRU-bounded), and the CLI's surface build and its refusal of
the fleet modes.

The engine: 64 agents (seed 3, padded to 8 rows), model years 2014-2018,
a 4-year cash-flow horizon; the surface is built for two of the three
years at a bucket of 16 rows, the engine's launch floor (a bucket of 8
launches 16 rows all the same, so 16 halves the sweep's launches).
"""

import functools
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from dgen_tpu.io import mmaptable as jmmap
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.io.mmaptable import MmapTable, MmapTableError, write_table
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.serve import __main__ as cli
from dgen_tpu_torch.serve.batcher import Microbatcher
from dgen_tpu_torch.serve.engine import QUERY_FIELDS, ServeEngine
from dgen_tpu_torch.serve.resultcache import ResultCache
from dgen_tpu_torch.serve.surface import (
    PROVENANCE_FIELDS,
    AnswerSurface,
    StaleSurfaceError,
    SurfaceError,
    build_surface,
    load_and_attach,
    provenance_key,
)

CFG = tcfg.ScenarioConfig(name="surf-test", start_year=2014, end_year=2018,
                          anchor_years=())
BUCKET = 16
SURFACE_YEARS = (0, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    pop = tsynth.generate_population(64, seed=3, pad_multiple=8, device="cpu")
    inputs = tscen.uniform_inputs(CFG, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions, device="cpu")
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, CFG,
                     tcfg.RunConfig(), econ_years=4, device="cpu")
    eng = ServeEngine(sim)
    eng.warmup([BUCKET])
    return eng


@pytest.fixture(scope="module")
def surface_dir(engine, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("surface"))
    build_surface(engine, d, BUCKET, year_indices=SURFACE_YEARS)
    return d


def _fresh_engine(engine):
    """A second engine over the same Simulation (no layers attached)."""
    return ServeEngine(engine.sim)


def _same_bits(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].tobytes() == b[f].tobytes(), f


# ---------------------------------------------------------------------------
# io.mmaptable
# ---------------------------------------------------------------------------

COLS = {"a": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        "b": np.arange(7, dtype=np.int32)}


def test_mmaptable_roundtrip_truncation_and_tamper(tmp_path):
    d = str(tmp_path / "t")
    header = write_table(d, COLS, meta={"k": "v"})
    t = MmapTable(d)
    t.verify()
    assert t.meta == {"k": "v"}
    for name, arr in COLS.items():
        np.testing.assert_array_equal(t.columns[name], arr)
        assert t.columns[name].dtype == arr.dtype
    # the same columns hash the same whatever the meta
    d2 = str(tmp_path / "t2")
    assert write_table(d2, COLS, meta={"other": 1})["content_hash"] == \
        header["content_hash"]
    bin_path = os.path.join(d, "table.bin")
    with open(bin_path, "rb") as f:
        blob = f.read()
    with open(bin_path, "wb") as f:          # deliberate damage
        f.write(blob[: len(blob) // 2])
    with pytest.raises(MmapTableError, match="truncated"):
        MmapTable(d)
    with open(bin_path, "wb") as f:          # same length, one bit flipped
        f.write(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    with pytest.raises(MmapTableError, match="content hash mismatch"):
        MmapTable(d).verify()
    os.remove(os.path.join(d2, "table.json"))
    with pytest.raises(MmapTableError, match="missing header"):
        MmapTable(d2)
    with pytest.raises(ValueError, match="no columns"):
        write_table(str(tmp_path / "t3"), {})


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_mmaptables_are_the_jax_package_format(tmp_path, writer, reader):
    """Either package reads the other's table: same bytes, same header."""
    write = write_table if writer == "port" else jmmap.write_table
    Table = MmapTable if reader == "port" else jmmap.MmapTable
    d = str(tmp_path / writer)
    header = write(d, COLS, meta={"bucket": 8})
    t = Table(d)
    t.verify()
    assert t.content_hash == header["content_hash"] and t.meta == {"bucket": 8}
    for name, arr in COLS.items():
        np.testing.assert_array_equal(t.columns[name], arr)
    other = str(tmp_path / "other")
    (jmmap.write_table if writer == "port" else write_table)(other, COLS, meta={"bucket": 8})
    for name in ("table.bin", "table.json"):
        with open(os.path.join(d, name), "rb") as a, open(os.path.join(other, name), "rb") as b:
            assert a.read() == b.read(), name


# ---------------------------------------------------------------------------
# The answer surface
# ---------------------------------------------------------------------------

def test_surface_is_bit_exact_vs_engine_at_its_bucket(engine, surface_dir):
    surf = AnswerSurface.load(surface_dir, engine)
    rng = np.random.default_rng(0)
    for yi in SURFACE_YEARS:
        rows = rng.choice(64, size=5, replace=False).astype(np.int32)
        got = surf.lookup(rows, yi)
        want = engine.query_rows(rows, yi, bucket=BUCKET)
        _same_bits(got, want)
    assert surf.stats()["hits"] == len(SURFACE_YEARS)
    assert surf.covers(0) and not surf.covers(1)
    assert surf.stats()["rows"] == 64 and surf.stats()["years"] == 2


@pytest.mark.parametrize("field,value", [
    ("config_hash", "deadbeef0000"), ("git_sha", "000000000000"),
    ("population_sha", "feedface"), ("n_rows", 999), ("years", [2014]),
    ("econ_years", 25), ("sizing_iters", 8)])
def test_stale_surface_is_refused_naming_the_field(engine, surface_dir, tmp_path,
                                                   field, value):
    assert field in PROVENANCE_FIELDS
    d = str(tmp_path / f"stale-{field}")
    shutil.copytree(surface_dir, d)
    hpath = os.path.join(d, "table.json")
    with open(hpath) as f:
        header = json.load(f)
    header["meta"]["provenance"][field] = value
    with open(hpath, "w") as f:              # deliberate tamper
        json.dump(header, f)
    with pytest.raises(StaleSurfaceError, match=field):
        AnswerSurface.load(d, engine)


def test_damaged_surface_is_refused(engine, surface_dir, tmp_path):
    d = str(tmp_path / "torn")
    shutil.copytree(surface_dir, d)
    bin_path = os.path.join(d, "table.bin")
    with open(bin_path, "rb") as f:
        blob = f.read()
    with open(bin_path, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with pytest.raises(SurfaceError, match="truncated"):
        AnswerSurface.load(d, engine)
    d = str(tmp_path / "version")
    shutil.copytree(surface_dir, d)
    hpath = os.path.join(d, "table.json")
    with open(hpath) as f:
        header = json.load(f)
    header["meta"]["surface_version"] = 0
    with open(hpath, "w") as f:
        json.dump(header, f)
    with pytest.raises(StaleSurfaceError, match="surface_version"):
        AnswerSurface.load(d, engine)


@pytest.mark.parametrize("kind", ["error", "truncate"])
def test_surface_load_fault_is_refused_loudly(engine, surface_dir, tmp_path, kind):
    """The surface_load site: the refusal is named and recorded, the engine
    answers, and (an ``error``) a clean retry attaches; a ``truncate``
    leaves the file halved, which the retry refuses as truncated."""
    d = str(tmp_path / kind)
    shutil.copytree(surface_dir, d)
    eng = _fresh_engine(engine)
    with faults.injected(f"surface_load:{kind}") as reg:
        reason = load_and_attach(eng, d)
    assert reg.fired("surface_load") == 1
    assert reason is not None and "surface_load" in reason
    assert eng.surface is None and eng.serve_stats()["surface_refused"] == reason
    retry = load_and_attach(eng, d)
    if kind == "error":
        assert retry is None and eng.surface is not None
    else:
        assert "truncated" in retry and eng.surface is None
        out = eng.query_rows(np.arange(3, dtype=np.int32), 0, bucket=BUCKET, key="")
        assert out["npv"].shape == (3,)


def test_batcher_surface_fast_path_and_counters(engine, surface_dir):
    eng = _fresh_engine(engine)
    assert load_and_attach(eng, surface_dir) is None
    bat = Microbatcher(eng, tcfg.ServeConfig(max_batch=BUCKET, min_bucket=BUCKET,
                                             max_wait_ms=2.0, port=0))
    try:
        ids = [3, 9]
        rows = eng.rows_for(ids)
        got = bat.query(ids, year=2014, timeout=60.0)
        _same_bits(got, eng.surface.lookup(rows, 0))
        stats = bat.stats()
        assert stats["surface_hits"] == 1 and stats["batches"] == 0
        assert stats["surface"]["hits"] >= 1
        # an override, or a year the surface does not cover, runs the engine
        bat.query(ids, year=2014, overrides={"scale": {"itc_fraction": 0.5}},
                  timeout=60.0)
        stats = bat.stats()
        assert stats["surface_hits"] == 1 and stats["batches"] == 1
    finally:
        bat.close()


# ---------------------------------------------------------------------------
# The result cache
# ---------------------------------------------------------------------------

def test_result_cache_hits_are_bit_exact_and_shared(engine, tmp_path):
    eng = _fresh_engine(engine)
    cache = ResultCache(str(tmp_path / "rc"), provenance_key(eng), max_entries=64)
    eng.attach_result_cache(cache)
    rows = np.array([2, 7, 11], dtype=np.int32)
    key = "ovr-key"
    first = eng.query_rows(rows, 1, bucket=BUCKET, key=key)
    assert cache.stats()["stores"] == 1
    second = eng.query_rows(rows, 1, bucket=BUCKET, key=key)
    assert cache.stats()["hits"] == 1
    _same_bits(first, second)
    # a second cache over the directory (another process) hits the entry
    eng2 = _fresh_engine(engine)
    cache2 = ResultCache(str(tmp_path / "rc"), provenance_key(eng2), max_entries=64)
    eng2.attach_result_cache(cache2)
    _same_bits(first, eng2.query_rows(rows, 1, bucket=BUCKET, key=key))
    assert cache2.stats()["hits"] == 1 and cache2.stats()["misses"] == 0
    # another provenance never aliases
    cache3 = ResultCache(str(tmp_path / "rc"), "other-version", max_entries=64)
    assert cache3.get(cache3.key(1, key, BUCKET, rows)) is None
    # key=None (the oracle path) bypasses the cache
    _same_bits(first, eng.query_rows(rows, 1, bucket=BUCKET))
    assert cache.stats()["stores"] == 1
    assert eng.serve_stats()["result_cache"]["hits"] == 1


def test_result_cache_is_a_bounded_lru(tmp_path):
    cache = ResultCache(str(tmp_path / "rc"), "pk", max_entries=3)
    keys = []
    for i in range(5):
        k = cache.key(0, f"k{i}", 4, np.arange(2))
        cache.put(k, {"npv": np.full(2, float(i), np.float32)})
        keys.append(k)
        time.sleep(0.01)                     # distinct mtimes order the scan
    assert cache.stats()["evictions"] == 2
    assert len([n for n in os.listdir(cache.dir) if n.endswith(".npz")]) == 3
    assert cache.get(keys[0]) is None and cache.get(keys[1]) is None
    np.testing.assert_array_equal(cache.get(keys[4])["npv"], np.full(2, 4.0, np.float32))
    with open(cache._path(keys[4]), "wb") as f:   # deliberate damage
        f.write(b"not an npz")
    assert cache.get(keys[4]) is None
    with pytest.raises(ValueError, match="max_entries"):
        ResultCache(str(tmp_path / "rc2"), max_entries=0)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_builds_a_surface_and_prints_its_header(tmp_path, capsys, monkeypatch):
    # the CLI's population padded to 8 rows, not 128: every padded row is
    # swept, at the plain path's pace
    monkeypatch.setattr(tsynth, "generate_population",
                        functools.partial(tsynth.generate_population, pad_multiple=8))
    d = str(tmp_path / "surf")
    assert cli.main(["--device", "cpu", "--build-surface", d, "--agents", "32",
                     "--end-year", "2015", "--max-batch", "8", "--econ-years", "5"]) == 0
    header = json.loads(capsys.readouterr().out)
    assert header["bucket"] == 8 and header["years"] == [0] and header["rows"] == 32
    assert header["provenance"]["econ_years"] == 5
    assert set(header["provenance"]) == set(PROVENANCE_FIELDS)
    t = MmapTable(d)
    t.verify()
    assert t.content_hash == header["content_hash"]
    assert set(t.columns) == set(QUERY_FIELDS)


@pytest.mark.parametrize("flags,runner", [(["--fleet", "2"], "_run_fleet"),
                                          (["--fleet", "2", "--autoscale"], "_run_fleet"),
                                          (["--replica-index", "0"], "_run_replica")])
def test_cli_refuses_the_fleet_modes(flags, runner, monkeypatch):
    """The fleet modes are ported: each reaches its runner, and the CLI
    refuses only what JAX's refuses (--fleet with --replica-index, a
    --build-surface with fleet flags)."""
    seen = []
    monkeypatch.setattr(cli, runner, seen.append)
    assert cli.main(["--device", "cpu", *flags]) == 0
    assert len(seen) == 1
    for bad in (["--fleet", "2", "--replica-index", "0"],
                ["--build-surface", "/nonexistent", *flags]):
        with pytest.raises(SystemExit):
            cli.main(["--device", "cpu", *bad])
