"""The port's national world generator (dgen_tpu_torch.models.synth)
against the JAX package's (dgen_tpu.models.synth) on the same specs: the
columns and their hashes byte for byte (whole, range and shard
materializations; the mixed and nem corpora, cohorts, rate switches),
the strata, the spec errors, the tables and banks, the saved world
(banks, tariffs.json and meta.json byte for byte; agents.npz against
agents.parquet), verify_world, and the CLI."""

import json
import os

import numpy as np
import pytest
import torch

from dgen_tpu.config import ScenarioConfig as JScenarioConfig
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models import synth as jns
from dgen_tpu.models.simulation import run_static_flags as j_run_static_flags
from dgen_tpu_torch.config import ScenarioConfig
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models import synth as tns
from dgen_tpu_torch.models.simulation import run_static_flags

#: specs the columns are held on: the JAX tests' small spec in both
#: corpora, with cohorts, with rate switches, on a state subset
SPECS = {
    "mixed": dict(n_agents=5000, seed=3, gen_chunk=512),
    "nem": dict(n_agents=5000, seed=3, gen_chunk=512, tariff_mix="nem"),
    "cohort": dict(n_agents=3000, seed=5, gen_chunk=512, cohort_frac=0.2,
                   cohort_years=(2026, 2030)),
    "rate_switch": dict(n_agents=3000, seed=1, gen_chunk=700, rate_switch_frac=0.3),
    "states": dict(n_agents=1000, seed=2, gen_chunk=256, states=("DE", "CA", "TX"),
                   n_regions=4, sector_weights=(0.7, 0.2, 0.0999995)),
}


def _both(name):
    kw = SPECS[name]
    return jns.NationalSpec(**kw), tns.NationalSpec(**kw)


def _assert_cols(got: dict, want: dict):
    assert list(got) == list(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        assert got[c].tobytes() == want[c].tobytes(), c


@pytest.mark.parametrize("name", sorted(SPECS))
def test_columns_and_hashes_equal_jax(name):
    js, ts = _both(name)
    whole = jns.generate_columns(js)
    _assert_cols(tns.generate_columns(ts), whole)
    # an arbitrary range split and every shard split
    cut = ts.n_agents * 13 // 50
    a, b = tns.generate_columns(ts, 0, cut), tns.generate_columns(ts, cut)
    _assert_cols({c: np.concatenate([a[c], b[c]]) for c in tns.COLUMNS}, whole)
    for n_shards in (2, 3, 4):
        for i in range(n_shards):
            rows = tns.shard_rows(ts, i, n_shards)
            assert rows == jns.shard_rows(js, i, n_shards)
            _assert_cols(tns.generate_columns(ts, *rows),
                         jns.generate_columns(js, *rows))
    _assert_cols(tns.generate_columns(ts, 7, 7), jns.generate_columns(js, 7, 7))
    assert tns.column_hashes(ts) == jns.column_hashes(js)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_state_counts_equal_jax(name):
    js, ts = _both(name)
    np.testing.assert_array_equal(tns.state_counts(ts), jns.state_counts(js))
    assert tns.state_counts(ts).sum() == ts.n_agents


def test_constants_and_corpora_equal_jax():
    assert tns.STATE_SHARES == jns.STATE_SHARES
    assert tns.GEN_CHUNK == jns.GEN_CHUNK and tns.TARIFF_MIXES == jns.TARIFF_MIXES
    assert tns.COLUMNS == jns.COLUMNS
    assert (tns.MIXED_SHAPE_CLASSES, tns.MIXED_SHAPE_WEIGHTS, tns.MIXED_SHAPE_POOLS) == \
        (jns.MIXED_SHAPE_CLASSES, jns.MIXED_SHAPE_WEIGHTS, jns.MIXED_SHAPE_POOLS)
    from dgen_tpu.ensemble.cohorts import COHORT_NEVER

    assert tns.COHORT_NEVER == COHORT_NEVER
    for mix in tns.TARIFF_MIXES:
        t, j = tns.make_national_tariffs(mix), jns.make_national_tariffs(mix)
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


BAD_SPECS = [
    dict(n_agents=0), dict(n_agents=10, gen_chunk=0), dict(n_agents=10, tariff_mix="bogus"),
    dict(n_agents=10, states=("DE", "XX")), dict(n_agents=10, sector_weights=(0.5, 0.2, 0.1)),
    dict(n_agents=10, cohort_frac=1.0), dict(n_agents=10, cohort_frac=-0.1),
    dict(n_agents=10, cohort_years=(2040, 2030)), dict(n_agents=10, cohort_years=(0, 2030)),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items() if k != "n_agents" or v == 0))
def test_spec_errors_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        jns.NationalSpec(**kw)
    with pytest.raises(ValueError) as got:
        tns.NationalSpec(**kw)
    assert str(got.value) == str(want.value)


def test_spec_json_roundtrip_equals_jax():
    for name in SPECS:
        js, ts = _both(name)
        assert ts.to_json() == js.to_json()
        assert tns.NationalSpec.from_json(js.to_json()) == ts
    # manifests written before cohorts load with cohorts off
    d = tns.NationalSpec(n_agents=10).to_json()
    del d["cohort_frac"], d["cohort_years"]
    assert tns.NationalSpec.from_json(d).cohort_frac == 0.0


def _table_equal(t, j):
    for f in ("agent_id", "mask", "state_idx", "sector_idx", "group_idx", "region_idx",
              "tariff_idx", "tariff_switch_idx", "load_idx", "cf_idx",
              "customers_in_bin", "load_kwh_per_customer_in_bin", "developable_frac",
              "one_time_charge", "nem_kw_limit", "nem_first_year", "nem_sunset_year",
              "switch_min_kw", "switch_max_kw"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.n_states == j.n_states


@pytest.mark.parametrize("name, rows", [("mixed", None), ("mixed", (1024, 2048)),
                                        ("cohort", None), ("cohort", (256, 1000))])
def test_tables_and_entry_years_equal_jax(name, rows):
    js, ts = _both(name)
    _table_equal(tns.generate_table(ts, rows=rows, device="cpu"),
                 jns.generate_table(js, rows=rows))
    np.testing.assert_array_equal(tns.generate_entry_years(ts, rows=rows),
                                  jns.generate_entry_years(js, rows=rows))


def test_world_banks_and_tariffs_equal_jax():
    js, ts = _both("states")
    jw, tw = jns.generate_world(js), tns.generate_world(ts, device="cpu")
    for f in ("load", "solar_cf", "wholesale"):
        np.testing.assert_array_equal(getattr(tw.profiles, f).numpy(),
                                      np.asarray(getattr(jw.profiles, f)))
    for f in ("price", "tier_cap", "sell_price", "hour_period", "fixed_monthly",
              "metering", "n_periods", "n_tiers"):
        np.testing.assert_array_equal(getattr(tw.tariffs, f).numpy(),
                                      np.asarray(getattr(jw.tariffs, f)))
    assert tw.n_regions == jw.n_regions == 4
    assert tw.table.agent_id.device.type == "cpu"


def test_static_flags_of_the_corpora_equal_jax():
    cfg_j = JScenarioConfig(name="t", start_year=2014, end_year=2016, anchor_years=())
    cfg_t = ScenarioConfig(name="t", start_year=2014, end_year=2016, anchor_years=())
    for mix, want in (("nem", (False, False)), ("mixed", (False, True))):
        spec = dict(n_agents=1024, tariff_mix=mix)
        jw = jns.generate_world(jns.NationalSpec(**spec))
        tw = tns.generate_world(tns.NationalSpec(**spec), device="cpu")
        jin = jscen.uniform_inputs(cfg_j, n_groups=jw.table.n_groups, n_regions=10)
        tin = tscen.uniform_inputs(cfg_t, n_groups=tw.table.n_groups, n_regions=10,
                                   device="cpu")
        assert run_static_flags(tw.table, tw.tariffs, tin, list(cfg_t.model_years)) \
            == j_run_static_flags(jw.table, jw.tariffs, jin, list(cfg_j.model_years)) \
            == want


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name, quant", [("mixed", True), ("cohort", False)])
def test_saved_world_equals_jax(tmp_path, name, quant):
    import pandas as pd

    kw = dict(SPECS[name], n_agents=700, gen_chunk=256)
    js, ts = jns.NationalSpec(**kw), tns.NationalSpec(**kw)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = jns.save_world(js, jdir, quant_banks=quant)
    tm = tns.save_world(ts, tdir, quant_banks=quant)
    for f in ("load_profiles.dgpb", "solar_cf.dgpb", "wholesale.dgpb", "tariffs.json",
              "meta.json"):
        assert _read(os.path.join(tdir, f)) == _read(os.path.join(jdir, f)), f
    # the port's agents.npz holds agents.parquet's columns
    df = pd.read_parquet(os.path.join(jdir, "agents.parquet"))
    with np.load(os.path.join(tdir, "agents.npz")) as z:
        assert sorted(z.files) == sorted(df.columns)
        for c in df.columns:
            np.testing.assert_array_equal(z[c], df[c].to_numpy(), err_msg=c)
            assert z[c].dtype == df[c].to_numpy().dtype, c
    # the manifests differ only where the agents file's name does
    jf, tf = jm.pop("files"), tm.pop("files")
    assert tm == jm
    assert jf.pop("agents.parquet") and tf.pop("agents.npz")
    assert tf == jf
    with open(os.path.join(tdir, tns.WORLD_MANIFEST)) as f:
        assert json.load(f)["files"].keys() == {"agents.npz", "tariffs.json", "meta.json"}


def test_saved_world_loads_as_the_generated_table(tmp_path):
    from dgen_tpu_torch.io import package, store

    ts = tns.NationalSpec(n_agents=512, gen_chunk=256, tariff_mix="nem")
    out = str(tmp_path / "world")
    assert tns.save_world(ts, out)["quant_banks"] is True
    pop = package.load_population(out, device="cpu")
    _table_equal(pop.table, tns.generate_table(ts, device="cpu"))
    codes, scales = store.read_bank_raw(os.path.join(out, "load_profiles.dgpb"))
    assert codes.dtype == torch.int8 and scales is not None
    f32 = tns.generate_banks(ts, device="cpu").load
    deq = scales[:, None] * codes.float()
    assert float((deq - f32).abs().max()) <= float(scales.max()) * 0.5 + 1e-7


def test_verify_world_catches_tampering_and_a_changed_spec(tmp_path):
    ts = tns.NationalSpec(n_agents=512, gen_chunk=256, tariff_mix="nem")
    out = str(tmp_path / "world")
    tns.save_world(ts, out)
    assert tns.verify_world(out) == []
    # a tampered bank
    with open(os.path.join(out, "solar_cf.dgpb"), "r+b") as f:
        f.seek(64)
        f.write(b"\xff")
    assert any("solar_cf" in p for p in tns.verify_world(out))
    # a tampered agent file
    with open(os.path.join(out, "agents.npz"), "r+b") as f:
        f.seek(128)
        f.write(b"\xff\xff\xff\xff")
    assert any("agents.npz" in p for p in tns.verify_world(out))
    # a manifest whose spec no longer generates its recorded columns
    path = os.path.join(out, tns.WORLD_MANIFEST)
    with open(path) as f:
        m = json.load(f)
    m["spec"]["seed"] = 9
    with open(path, "w") as f:
        json.dump(m, f)
    assert any(p.startswith("column ") for p in tns.verify_world(out))
    m["spec"]["tariff_mix"] = "bogus"
    with open(path, "w") as f:
        json.dump(m, f)
    assert tns.verify_world(out)[0].startswith("bad spec")
    os.remove(path)
    assert tns.verify_world(out)[0].startswith("unreadable")


def test_shard_rows_equal_jax_and_refuse_tiny_shards():
    spec_kw = dict(n_agents=100_003)
    js, ts = jns.NationalSpec(**spec_kw), tns.NationalSpec(**spec_kw)
    for n_shards, pad in ((1, 1), (3, 1), (8, 128), (7, 256)):
        assert [tns.shard_rows(ts, i, n_shards, pad) for i in range(n_shards)] == \
            [jns.shard_rows(js, i, n_shards, pad) for i in range(n_shards)]
    with pytest.raises(ValueError, match="fewer than one pad unit"):
        tns.shard_rows(tns.NationalSpec(n_agents=1000), 0, 8, pad_multiple=128)
    with pytest.raises(ValueError, match="outside"):
        tns.shard_rows(ts, 3, 3)


def test_cli_generate_and_verify_exit_codes(tmp_path, capsys):
    out = str(tmp_path / "w")
    assert tns.main(["generate", "--agents", "300", "--gen-chunk", "128",
                     "--tariff-mix", "mixed", "--cohort-frac", "0.1",
                     "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"world": out, "agents": 300, "states": 49, "quant_banks": True}
    assert tns.main(["verify", out]) == 0
    with open(os.path.join(out, "wholesale.dgpb"), "r+b") as f:
        f.seek(80)
        f.write(b"\x01\x02")
    capsys.readouterr()
    assert tns.main(["verify", out]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("verify: bank wholesale.dgpb")
    assert json.loads(lines[-1])["clean"] is False
    with pytest.raises(SystemExit) as e:
        tns.main(["generate", "--agents", "10", "--tariff-mix", "bogus", "--out", out])
    assert e.value.code == 2


def test_cli_smoke_steps_two_years_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "smoke")
    assert tns.main(["smoke", "--agents", "48", "--device", "cpu", "--out", out]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["smoke"] == "ok" and rec["manifest_ok"] is True
    assert rec["years"] == [2014, 2016] and rec["mesh"] == "1x1"
    assert os.path.isdir(os.path.join(out, "ckpt"))


@pytest.mark.parametrize("mesh", ["2x4", "1x8"])
def test_cli_smoke_refuses_a_mesh(tmp_path, mesh):
    # eight ranks of 48 agents: each rank's block of rows (shard_rows at
    # the smoke's pad unit) would hold 6 rows; refused before any rank
    # process starts
    with pytest.raises(ValueError, match="fewer than one pad unit"):
        tns.main(["smoke", "--agents", "48", "--device", "cpu", "--mesh", mesh,
                  "--out", str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s")
    with pytest.raises(ValueError, match="bad mesh shape"):
        tns.main(["smoke", "--device", "cpu", "--mesh", "2by4"])
