"""The run outputs of the PyTorch port (dgen_tpu_torch/io/export.py) held
against the JAX package's exporter (dgen_tpu/io/export.py).

* The int16 quantization: codes, scales and non-finite counts equal the
  JAX function's exactly, for vectors, a [n, 26] series, non-finite
  elements and an all-zero field.
* The same seeded YearOutputs go through both exporters, compact and full
  precision: the port's ``to_parquet`` of its ``.npz`` run directory reads
  back, through the JAX package's ``load_surface``, frame for frame equal
  to the JAX package's parquet (``assert_frame_equal``, exact), its
  ``agents.parquet`` too, and ``meta.json`` has the JAX package's keys
  but for ``jax_backend``, which is ``backend`` here.
* A 64-agent world runs 3 years with exports in both packages; the
  surfaces hold at tests/test_torch_slice.py's per-agent tolerance (rtol
  1e-3, atol 1e-4 x the field's scale), battery adopters equal.
* The JAX package's own exporter contracts (tests/test_io_runtime.py),
  case by case: wrong state names, the deferred export surviving a
  mid-run crash, compact quantization within its bound, a failed
  final-year export raising, the surfaces' shapes, the non-finite count.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import export as jexp
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import export as texp
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation as TSimulation
from dgen_tpu_torch.models.simulation import YearOutputs

SURFACES = ("agent_outputs", "finance_series", "state_hourly")


def _quant_inputs(case: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if case == "vectors":
        return [(rng.standard_normal(20000) * 10.0 ** rng.uniform(-4, 7)).astype(np.float32)
                for _ in range(5)]
    if case == "series":
        return [(rng.standard_normal((5000, 26)) * np.logspace(0, 6, 26)).astype(np.float32)]
    if case == "nonfinite":
        x = rng.standard_normal(1000).astype(np.float32)
        x[[3, 7, 9, 500]] = [np.nan, np.inf, -np.inf, np.nan]
        s = rng.standard_normal((300, 26)).astype(np.float32)
        s[5, 2], s[7, 25] = np.inf, np.nan
        return [x, s]
    # an all-zero field, and codes on the rounding ties of its scale
    t = (np.arange(-64, 65, dtype=np.float32) + 0.5) * np.float32(3.0) / np.float32(32766)
    return [np.zeros(17, np.float32), np.append(t, np.float32(3.0))]


@pytest.mark.parametrize("case,seed", [("vectors", 0), ("vectors", 1), ("series", 2),
                                       ("nonfinite", 3), ("zeros_and_ties", 4)])
def test_quantize_i16_equals_the_jax_packages(case, seed):
    import jax

    xs = _quant_inputs(case, seed)
    jq, js, jn = jax.jit(jexp._quantize_i16)(xs)
    tq, ts, tn = texp._quantize_i16([torch.from_numpy(x) for x in xs])
    for i, x in enumerate(xs):
        assert tq[i].dtype == torch.int16
        np.testing.assert_array_equal(tq[i].numpy(), np.asarray(jq[i]), err_msg=f"codes {i}")
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]), err_msg=f"scale {i}")
        assert int(tn[i]) == int(jn[i]) == int((~np.isfinite(x)).sum())


# ---------------------------------------------------------------------------
# The same seeded outputs through both exporters
# ---------------------------------------------------------------------------

N_AGENTS = 40
YEARS = (2014, 2016)


@pytest.fixture(scope="module")
def tables():
    kw = dict(states=["DE", "CA", "TX"], seed=5, pad_multiple=16)
    return (jsynth.generate_population(N_AGENTS, **kw),
            tsynth.generate_population(N_AGENTS, device="cpu", **kw))


def _seeded_outputs(n_rows: int, n_states: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for f in texp.AGENT_OUTPUT_FIELDS:
        out[f] = (rng.standard_normal(n_rows) * 10.0 ** rng.uniform(-2, 5)).astype(np.float32)
        if f.endswith("_cum") or f == "number_of_adopters":
            out[f] = np.abs(out[f])
    out["new_batt_adopters"] = rng.integers(0, 4, n_rows).astype(np.float32)
    out["cash_flow"] = (rng.standard_normal((n_rows, 26)) * np.logspace(4, 2, 26)
                        ).astype(np.float32)
    out["energy_value_pv_only"] = rng.random((n_rows, 25), dtype=np.float32) * 900
    out["state_hourly_net_mw"] = rng.random((n_states, 8760), dtype=np.float32) * 50
    return out


def _export_both(tables, tmp_path, compact: bool):
    jp, tp = tables
    mask = np.asarray(jp.table.mask)
    ids = np.asarray(jp.table.agent_id)
    n_rows, n_states = len(mask), jp.table.n_states
    states = list(jsynth.STATES)
    jx = jexp.RunExporter(str(tmp_path / "jax"), ids, mask, state_names=states,
                          compact=compact, meta={"preset": "t"},
                          static_frame=jexp.static_frame_from_table(jp.table, states))
    tx = texp.RunExporter(str(tmp_path / "port"), tp.table.agent_id.numpy(),
                          tp.table.mask.numpy(), state_names=states, compact=compact,
                          meta={"preset": "t"}, device="cpu",
                          static_frame=texp.static_frame_from_table(tp.table, states))
    for yi, year in enumerate(YEARS):
        arrays = _seeded_outputs(n_rows, n_states, seed=yi)
        jx(year, yi, type("Outs", (), arrays)())
        tx(year, yi, YearOutputs(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    texp.to_parquet(str(tmp_path / "port"), str(tmp_path / "port_pq"))
    return tmp_path / "jax", tmp_path / "port", tmp_path / "port_pq"


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_exporter_matches_the_jax_packages_frame_for_frame(tables, tmp_path, compact):
    jdir, tdir, pdir = _export_both(tables, tmp_path, compact)
    for name in SURFACES:
        ref = jexp.load_surface(str(jdir), name)
        got = jexp.load_surface(str(pdir), name)
        pd.testing.assert_frame_equal(got, ref, check_exact=True, obj=name)
        assert len(ref) and list(got.columns) == list(ref.columns)
    assert ("energy_value" in jexp.load_surface(str(jdir), "finance_series")) is not compact
    pd.testing.assert_frame_equal(pd.read_parquet(pdir / "agents.parquet"),
                                  pd.read_parquet(jdir / "agents.parquet"), check_exact=True)
    jmeta = json.loads((jdir / "meta.json").read_text())
    tmeta = json.loads((tdir / "meta.json").read_text())
    assert set(tmeta) - {"backend"} == set(jmeta) - {"jax_backend"}
    assert tmeta["backend"] == "cpu" and tmeta["export_compact"] is compact
    assert json.loads((pdir / "meta.json").read_text()) == tmeta
    # the card path's files need no pickle, and the port's loader reads
    # the same columns the parquet holds
    ours = texp.load_surface(str(tdir), "agent_outputs")
    ref = jexp.load_surface(str(jdir), "agent_outputs")
    for col in ref.columns:
        np.testing.assert_array_equal(ours[col], ref[col].to_numpy(), err_msg=col)
    for name in ("agents.npz", "agent_outputs/year=2014.npz", "state_hourly/year=2016.npz"):
        with np.load(tdir / name, allow_pickle=False) as z:
            assert all(z[k].dtype != object for k in z.files)


def test_npz_partitions_are_byte_stable(tables, tmp_path):
    """Two exports of the same outputs give the same bytes (every zip
    entry carries a fixed time stamp)."""
    a = _export_both(tables, tmp_path / "a", compact=True)[1]
    b = _export_both(tables, tmp_path / "b", compact=True)[1]
    for name in SURFACES:
        for f in sorted(os.listdir(a / name)):
            assert (a / name / f).read_bytes() == (b / name / f).read_bytes(), (name, f)
    assert (a / "agents.npz").read_bytes() == (b / "agents.npz").read_bytes()


# ---------------------------------------------------------------------------
# One world through both packages with exports on
# ---------------------------------------------------------------------------

RUN_AGENTS = 64
RUN_CFG = dict(start_year=2014, end_year=2018, anchor_years=())  # 3 model years


def _world(pkg_synth, pkg_scen, cfg, **dev):
    pop = pkg_synth.generate_population(RUN_AGENTS, states=["DE", "CA"], seed=7,
                                        pad_multiple=32, **dev)
    g = pop.table.n_groups
    inputs = pkg_scen.uniform_inputs(
        cfg, n_groups=g, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(g, 0.4, np.float32)}, **dev)
    return pop, inputs


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    td = tmp_path_factory.mktemp("export-run")
    jc, tc = jcfg.ScenarioConfig(**RUN_CFG), tcfg.ScenarioConfig(**RUN_CFG)
    jp, jin = _world(jsynth, jscen, jc)
    tp, tin = _world(tsynth, tscen, tc, device="cpu")
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs, jin, jc,
                       jcfg.RunConfig(sizing_iters=4), with_hourly=True)
    tsim = TSimulation(tp.table, tp.profiles, tp.tariffs, tin, tc,
                       tcfg.RunConfig(sizing_iters=4), with_hourly=True, device="cpu")
    jsim.run(callback=jexp.RunExporter(str(td / "jax"), np.asarray(jp.table.agent_id),
                                       np.asarray(jp.table.mask)), collect=False)
    tsim.run(callback=texp.RunExporter(str(td / "port"), tsim.host_agent_id,
                                       tsim.host_mask, device="cpu"), collect=False)
    return td / "jax", td / "port"


def test_run_surfaces_match_the_jax_packages(run_dirs):
    jdir, tdir = run_dirs
    ref = jexp.load_surface(str(jdir), "agent_outputs")
    got = texp.load_surface(str(tdir), "agent_outputs")
    assert sorted(set(got["year"])) == [2014, 2016, 2018] and len(got["year"]) == len(ref)
    np.testing.assert_array_equal(got["agent_id"], ref["agent_id"].to_numpy())
    for f in texp.AGENT_OUTPUT_FIELDS:
        r = ref[f].to_numpy()
        scale = float(np.abs(r).max()) or 1.0
        np.testing.assert_allclose(got[f], r, rtol=1e-3, atol=1e-4 * scale, err_msg=f)
    for f in ("new_batt_adopters", "batt_adopters_cum"):
        np.testing.assert_array_equal(got[f], ref[f].to_numpy(), err_msg=f)
    assert got["batt_adopters_cum"].sum() > 0
    fin_r = np.stack(jexp.load_surface(str(jdir), "finance_series")["cash_flow"].to_numpy())
    fin = texp.load_surface(str(tdir), "finance_series")["cash_flow"]
    assert fin.shape == fin_r.shape == (len(ref), 26)
    bound = 1e-3 * np.abs(fin_r) + 1e-4 * np.abs(fin_r).max(axis=0)[None, :]
    assert (np.abs(fin - fin_r) <= bound).all(), np.abs(fin - fin_r).max()
    sh_r = jexp.load_surface(str(jdir), "state_hourly")
    sh = texp.load_surface(str(tdir), "state_hourly")
    assert sh["state"].tolist() == sh_r["state"].tolist()
    np.testing.assert_allclose(sh["net_load_mw"], np.stack(sh_r["net_load_mw"].to_numpy()),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The JAX package's exporter contracts (tests/test_io_runtime.py)
# ---------------------------------------------------------------------------

def _small_sim(with_hourly=False, years=(2014, 2018)):
    cfg = tcfg.ScenarioConfig(name="ck", start_year=years[0], end_year=years[1],
                              anchor_years=())
    pop = tsynth.generate_population(96, states=["DE", "CA"], seed=2, pad_multiple=32,
                                     device="cpu")
    inputs = tscen.uniform_inputs(
        cfg, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(pop.table.n_groups, 0.3, np.float32)},
        device="cpu")
    sim = TSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      tcfg.RunConfig(sizing_iters=4), with_hourly=with_hourly, device="cpu")
    return sim, pop


def test_exporter_rejects_wrong_state_names(tmp_path):
    ex = texp.RunExporter(str(tmp_path), agent_id=np.arange(4), mask=np.ones(4),
                          state_names=["DE", "CA"], device="cpu")
    with pytest.raises(ValueError, match="state_names"):
        ex.write_state_hourly(2014, np.zeros((49, 8760), np.float32))


@pytest.mark.parametrize("async_io", [False, True], ids=["serialized", "pipeline"])
def test_deferred_export_survives_midrun_crash(tmp_path, async_io):
    """A step failure while dispatching year 3 still leaves years 1 and 2
    exported (the deferred flush on the serialized path, the drain on the
    pipeline), each once."""
    sim, pop = _small_sim()
    sim.run_config = tcfg.RunConfig(sizing_iters=4, async_host_io=async_io)
    exporter = texp.RunExporter(str(tmp_path / "run"), sim.host_agent_id, sim.host_mask,
                                device="cpu")
    calls = {"n": 0}
    orig_step = sim.step

    def flaky_step(carry, yi, first_year):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected dispatch failure")
        return orig_step(carry, yi, first_year)

    sim.step = flaky_step
    with pytest.raises(RuntimeError, match="injected"):
        sim.run(callback=exporter, collect=False)
    ao = texp.load_surface(str(tmp_path / "run"), "agent_outputs")
    assert sorted(set(ao["year"])) == [2014, 2016]
    assert len(ao["year"]) == 2 * int(pop.table.mask.sum())


@pytest.fixture(scope="module")
def compact_and_full(tmp_path_factory):
    td = tmp_path_factory.mktemp("compact")
    sim, _ = _small_sim(with_hourly=True)
    kw = dict(agent_id=sim.host_agent_id, mask=sim.host_mask, device="cpu",
              state_names=list(tsynth.STATES))
    full = texp.RunExporter(str(td / "full"), compact=False, **kw)
    comp = texp.RunExporter(str(td / "comp"), compact=True, **kw)

    def both(year, yi, outs):
        full(year, yi, outs)
        comp(year, yi, outs)

    sim.run(callback=both, collect=False)
    return sim, full, comp, td


def test_compact_export_quantization(compact_and_full):
    """Compact exports reconstruct within max|x| / 65532 a column, keep the
    cumulative fields exact and drop energy_value; full precision keeps
    it."""
    _, full, comp, td = compact_and_full
    ao_f = texp.load_surface(str(td / "full"), "agent_outputs")
    ao_c = texp.load_surface(str(td / "comp"), "agent_outputs")
    for col in texp.AGENT_OUTPUT_FIELDS:
        a, b = ao_f[col], ao_c[col]
        if col in texp._EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=col)
        else:
            tol = max(np.abs(a).max(), 1e-9) / 65532 * 1.01
            np.testing.assert_allclose(a, b, atol=tol, err_msg=col)
    fs_f = texp.load_surface(str(td / "full"), "finance_series")
    fs_c = texp.load_surface(str(td / "comp"), "finance_series")
    assert "energy_value" in fs_f and "energy_value" not in fs_c
    col_tol = np.abs(fs_f["cash_flow"]).max(axis=0) / 65532 * 1.01 + 1e-9
    assert (np.abs(fs_f["cash_flow"] - fs_c["cash_flow"]) <= col_tol[None, :]).all()
    assert full.meta["export_compact"] is False and comp.meta["export_compact"] is True


def test_exporter_surfaces(compact_and_full):
    sim, _, _, td = compact_and_full
    n_real = int(sim.host_mask.sum())
    ao = texp.load_surface(str(td / "comp"), "agent_outputs")
    assert len(ao["year"]) == n_real * len(sim.years)
    assert set(texp.AGENT_OUTPUT_FIELDS) <= set(ao)
    by_year = [ao["system_kw_cum"][ao["year"] == y].sum() for y in sim.years]
    assert (np.diff(by_year) >= -1e-3).all()
    fs = texp.load_surface(str(td / "comp"), "finance_series")
    assert fs["cash_flow"].shape == (n_real * len(sim.years), 26)
    sh = texp.load_surface(str(td / "comp"), "state_hourly")
    assert sh["net_load_mw"].shape == (sim.table.n_states * len(sim.years), 8760)
    assert sh["state"][:2].tolist() == list(tsynth.STATES[:2])


@pytest.mark.parametrize("async_io", [False, True], ids=["serialized", "pipeline"])
def test_final_year_export_failure_raises(async_io):
    """On the success path a failing final-year export surfaces: a run
    never reports success with its last year's partitions missing."""
    sim, _ = _small_sim()
    sim.run_config = tcfg.RunConfig(sizing_iters=4, async_host_io=async_io)
    n_years = len(sim.years)
    calls = {"n": 0}

    def flaky_exporter(year, yi, outs):
        calls["n"] += 1
        if calls["n"] == n_years:
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        sim.run(callback=flaky_exporter, collect=False)
    assert calls["n"] == n_years


def test_exporter_stamps_nonfinite_zeroed_count(tmp_path, caplog):
    n = 6
    ex = texp.RunExporter(str(tmp_path / "run"), agent_id=np.arange(n),
                          mask=np.ones(n, np.float32), compact=True, device="cpu")
    assert json.load(open(tmp_path / "run" / "meta.json"))["nonfinite_zeroed"] == 0
    dirty = torch.tensor([1.0, np.nan, 2.0, np.inf, -np.inf, 3.0])
    clean = torch.arange(n, dtype=torch.float32)
    rows_d, rows_c = ex._local_fields([dirty, clean], (True, True),
                                      names=("npv", "system_kw"), year=2016)
    np.testing.assert_array_equal(rows_d[[1, 3, 4]], 0.0)
    np.testing.assert_allclose(rows_c, np.arange(n), atol=1e-3)
    ex._flush_meta()
    meta = json.load(open(tmp_path / "run" / "meta.json"))
    assert meta["nonfinite_zeroed"] == 3
    assert meta["quarantine"]["nonfinite_zeroed_by_field"] == {"npv": 3}
    assert "zeroed 3 non-finite value(s) in 'npv' at year 2016" in caplog.text
