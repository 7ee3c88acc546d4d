"""The serving stack of the PyTorch port (``dgen_tpu_torch.serve``) against
the JAX package's (``dgen_tpu.serve``), on the population of
tests/test_serve.py cut to 64 agents (seed 3, padded to 8 rows), model
years 2014-2020, a 5-year cash-flow horizon in both packages (the plain
bucket sums and the plain dispatch loop set the CPU's pace, ~1 s a
bucket), and agent QID quarantined by the run config in both.

Bounds against the JAX package are tests/test_torch_sizing.py's for the
fast path's first year: ``system_kw`` rtol 1e-4; NPV and every cash-flow
entry within 1e-4 x the value + 1e-4 x the flow scale (25 years of the
no-system bill); payback within 0.1 year; bills and battery sizes rtol
1e-4 / atol 1e-2.

The bucket contract (tests/test_serve.py:64-117): a bucket launches at
least ``LAUNCH_ROW_FLOOR`` rows, so on the CPU every bucket up to the
floor runs the same plain products and an agent's answer is the same
bits at bucket=None, 4, 8 and 16; a larger bucket holds JAX's
cross-shape bound (rtol 1e-5, atol 1e-4), and bit for bit where the
plain path gives it. The microbatcher's queue tests run on a stub
engine (no device work); its fault test on the real one.
"""

import dataclasses as dc
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu.serve import engine as jengine
from dgen_tpu.serve import server as jserver
from dgen_tpu.utils import timing as jtiming
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import Simulation
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.serve import engine as tengine
from dgen_tpu_torch.serve.batcher import Microbatcher, QueueFullError
from dgen_tpu_torch.serve.engine import (
    LAUNCH_ROW_FLOOR,
    OverrideError,
    ServeEngine,
    apply_overrides,
    override_key,
)
from dgen_tpu_torch.serve.server import ServeApp, drain, rows_to_json, start_in_thread
from dgen_tpu_torch.utils import timing

N_AGENTS = 64
POP_KW = dict(seed=3, pad_multiple=8)
CFG_KW = dict(name="serve-test", start_year=2014, end_year=2020, anchor_years=())
ECON = 5
QID = 9
IDS = [5, 17, 40]
YEAR = 2016
OVR = {"scale": {"itc_fraction": 0.5}}
SERVE_CFG = tcfg.ServeConfig(max_batch=8, min_bucket=4, max_wait_ms=50.0,
                             max_queue=32, port=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    pop = tsynth.generate_population(N_AGENTS, device="cpu", **POP_KW)
    cfg = tcfg.ScenarioConfig(**CFG_KW)
    inputs = tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions, device="cpu")
    sim = Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                     tcfg.RunConfig(quarantine_ids=(QID,)), econ_years=ECON,
                     device="cpu")
    return ServeEngine(sim)


@pytest.fixture(scope="module")
def jax_engine():
    pop = jsynth.generate_population(N_AGENTS, **POP_KW)
    cfg = jcfg.ScenarioConfig(**CFG_KW)
    inputs = jscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions)
    sim = JSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      jcfg.RunConfig(quarantine_ids=(QID,)), econ_years=ECON)
    return jengine.ServeEngine(sim)


#: (bucket, override) cases of IDS at YEAR that the tests share
CASES = [(None, None), (4, None), (8, None), (4, OVR)]


@pytest.fixture(scope="module")
def answers(engine):
    """The port's answers of CASES, and of bucket 16 and 32."""
    out = {(b, override_key(o)): engine.query(IDS, year=YEAR, overrides=o, bucket=b)
           for b, o in CASES}
    for b in (16, 32):
        out[(b, "")] = engine.query(IDS, year=YEAR, bucket=b)
    return out


def assert_close_to_jax(got: dict, ref: dict) -> None:
    """tests/test_torch_sizing.py's bounds for the fast path's first year."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(got["agent_id"], ref["agent_id"])
    np.testing.assert_array_equal(got["nem_allowed"], ref["nem_allowed"])
    np.testing.assert_allclose(got["system_kw"], ref["system_kw"], rtol=1e-4)
    flow = 25.0 * np.abs(ref["first_year_bill_without_system"])
    assert np.all(np.abs(got["npv"] - ref["npv"])
                  <= 1e-4 * np.abs(ref["npv"]) + 1e-4 * flow)
    assert np.all(np.abs(got["cash_flow"] - ref["cash_flow"])
                  <= 1e-4 * np.abs(ref["cash_flow"]) + 1e-4 * flow[:, None])
    assert np.all(np.abs(got["payback_period"] - ref["payback_period"]) <= 0.1 + 1e-6)
    for k in ("first_year_bill_with_system", "first_year_bill_without_system",
              "batt_kw", "batt_kwh", "bill_savings_y1", "annual_kwh"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-2, err_msg=k)


def _same_bits(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[f].dtype == b[f].dtype and a[f].tobytes() == b[f].tobytes() for f in a)


# ---------------------------------------------------------------------------
# Answers against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket,overrides", CASES,
                         ids=["single-shot", "bucket4", "bucket8", "bucket4-override"])
def test_answers_match_jax(answers, jax_engine, bucket, overrides):
    got = answers[(bucket, override_key(overrides))]
    ref = jax_engine.query(IDS, year=YEAR, overrides=overrides, bucket=bucket)
    assert set(got) == set(ref) == set(tengine.QUERY_FIELDS)
    assert tengine.QUERY_FIELDS == jengine.QUERY_FIELDS
    assert_close_to_jax(got, ref)
    for f, v in got.items():
        assert v.shape == np.asarray(ref[f]).shape, f


def test_override_moves_npv_and_only_the_touched_leaves(answers, engine):
    base, ovr = answers[(4, "")], answers[(4, override_key(OVR))]
    # a smaller ITC can only lower NPV, strictly where capex is nonzero
    assert np.all(ovr["npv"] <= base["npv"] + 1e-6)
    assert np.any(ovr["npv"] < base["npv"] - 1.0)
    v = engine.inputs_for(OVR)
    assert v is engine.inputs_for(OVR)            # the variant is cached
    for f in dc.fields(v):
        same = getattr(v, f.name) is getattr(engine.sim.inputs, f.name)
        assert same == (f.name != "itc_fraction"), f.name


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------

VALID_OVERRIDES = [
    {"set": {"itc_fraction": 0.26}},
    {"scale": {"loan_term_yrs": 0.5}},                         # 20 -> 10, exact
    {"set": {"loan_term_yrs": 15}, "scale": {"itc_fraction": 0.0}},
    {"set": {"itc_fraction": [0.1, 0.2, 0.3]}},                # broadcasts over Y
]


@pytest.mark.parametrize("overrides", VALID_OVERRIDES,
                         ids=["set", "int-scale", "set-and-scale", "broadcast"])
def test_apply_overrides_match_jax(engine, jax_engine, overrides):
    got = apply_overrides(engine.sim.inputs, overrides)
    ref = jengine.apply_overrides(jax_engine.sim.inputs, overrides)
    for f in dc.fields(got):
        g = getattr(got, f.name).numpy()
        r = np.asarray(getattr(ref, f.name))
        assert g.shape == r.shape, f.name
        assert g.dtype.name == r.dtype.name, f.name
        np.testing.assert_array_equal(g, r, err_msg=f.name)


BAD_OVERRIDES = [
    ({"replace": {"itc_fraction": 1.0}}, "unknown override op"),
    ({"set": {"no_such_field": 1.0}}, "unknown ScenarioInputs"),
    ({"set": {"loan_term_yrs": 12.7}}, "lossy integer"),
    ({"scale": {"loan_term_yrs": 0.77}}, "lossy integer"),     # 15.4 is off the grid
    ({"set": {"itc_fraction": [1.0, 2.0]}}, "does not fit"),   # [Y, 3] takes no [2]
]


@pytest.mark.parametrize("overrides,match", BAD_OVERRIDES,
                         ids=["op", "field", "lossy-set", "lossy-scale", "shape"])
def test_bad_overrides_are_refused_as_in_jax(engine, jax_engine, overrides, match):
    with pytest.raises(OverrideError, match=match):
        apply_overrides(engine.sim.inputs, overrides)
    with pytest.raises(jengine.OverrideError, match=match):
        jengine.apply_overrides(jax_engine.sim.inputs, overrides)


def test_override_key_is_canonical():
    for ovr in ({"scale": {"a": 1.0, "b": 2.0}}, {"scale": {"b": 2.0, "a": 1.0}},
                None, {}, OVR):
        assert override_key(ovr) == jengine.override_key(ovr)
    assert override_key({"scale": {"a": 1.0, "b": 2.0}}) == \
        override_key({"scale": {"b": 2.0, "a": 1.0}})
    assert override_key(None) == override_key({}) == ""


# ---------------------------------------------------------------------------
# The bucket contract
# ---------------------------------------------------------------------------

def test_buckets_up_to_the_launch_floor_are_bit_for_bit(answers):
    ref = answers[(None, "")]
    for b in (4, 8, 16):
        assert b <= LAUNCH_ROW_FLOOR
        assert _same_bits(answers[(b, "")], ref), b


def test_larger_buckets_hold_jax_cross_shape_bound(answers):
    """Above the floor the CPU's plain products may choose by the row
    count; JAX's bound (tests/test_serve.py:95-104) holds, and here the
    plain path gives bit for bit."""
    ref, wide = answers[(None, "")], answers[(32, "")]
    for f in ("system_kw", "npv", "payback_period", "bill_savings_y1"):
        np.testing.assert_allclose(wide[f], ref[f], rtol=1e-5, atol=1e-4, err_msg=f)
    assert _same_bits(wide, ref)


def test_padding_rows_are_inert(engine, answers):
    """The same agent padded into buckets of the same shape with other
    agents is bit for bit the same."""
    a = engine.query([IDS[0]], year=YEAR, bucket=8)
    b = answers[(8, "")]
    for f in tengine.QUERY_FIELDS:
        assert a[f][0].tobytes() == b[f][0].tobytes(), f


def test_every_bucket_launches_at_least_the_floor(engine, monkeypatch):
    """query_rows pads by the first requested row up to the bucket, then up
    to LAUNCH_ROW_FLOOR, and slices the requested rows back out."""
    seen = []

    def fake(table, profiles, tariffs, inputs, idx, year_idx, **kw):
        seen.append(idx.tolist())
        z = torch.zeros(idx.shape[0])
        return tengine.QueryOutputs(
            **{f: (table.agent_id[idx] if f == "agent_id" else
                   torch.zeros(idx.shape[0], ECON + 1) if f == "cash_flow" else z)
               for f in tengine.QUERY_FIELDS})

    monkeypatch.setattr(tengine, "query_program", fake)
    rows = engine.rows_for(IDS)
    for bucket, width in ((None, 16), (4, 16), (16, 16), (32, 32)):
        out = engine.query_rows(rows, 1, bucket=bucket)
        assert len(seen[-1]) == width
        assert seen[-1][:3] == rows.tolist()
        assert seen[-1][3:] == [int(rows[0])] * (width - 3)
        np.testing.assert_array_equal(out["agent_id"], IDS)
    with pytest.raises(ValueError, match="bucket 2 < 3"):
        engine.query_rows(rows, 1, bucket=2)
    np.testing.assert_array_equal(tengine.launch_rows(np.array([7], np.int32), 1),
                                  [7] * LAUNCH_ROW_FLOOR)


def test_ids_and_years_are_validated(engine, jax_engine):
    for eng, quarantined in ((engine, tengine.QuarantinedAgentError), (jax_engine, None)):
        with pytest.raises(KeyError, match="unknown agent_id"):
            eng.rows_for([10 ** 9])
        with pytest.raises(KeyError, match="unknown agent_id"):
            eng.rows_for([17.9])                 # never truncated onto a neighbour
        with pytest.raises(KeyError, match="not on the model grid"):
            eng.year_index(1999)
        with pytest.raises(KeyError, match="not on the model grid"):
            eng.year_index(2016.7)
        assert eng.year_index(None) == 0 and eng.year_index(2018) == 2
    with pytest.raises(tengine.QuarantinedAgentError) as e:
        engine.rows_for([QID])
    assert e.value.agent_id == QID and e.value.reasons == ["config:quarantine_ids"]
    assert engine.n_agents == jax_engine.n_agents == N_AGENTS - 1
    np.testing.assert_array_equal(engine.rows_for(IDS), jax_engine.rows_for(IDS))


# ---------------------------------------------------------------------------
# The microbatcher
# ---------------------------------------------------------------------------

class _StubEngine:
    """The engine surface the batcher reads, answering each row with its
    id at once (no device work)."""

    years = [2014, 2016]
    warm_buckets = ()
    surface = None

    def __init__(self, delay_s: float = 0.0) -> None:
        self.delay_s = delay_s
        self.buckets = []

    def rows_for(self, ids):
        for a in ids:
            if int(a) != a or not 0 <= a < 10 ** 6:
                raise KeyError(f"unknown agent_id {a!r}")
        return np.asarray(ids, dtype=np.int32)

    def year_index(self, year):
        if year is None:
            return 0
        if year not in self.years:
            raise KeyError(f"year {year!r} is not on the model grid {self.years}")
        return self.years.index(year)

    def inputs_for(self, overrides):
        return None

    def serve_stats(self):
        return {}

    def query_rows(self, rows, year_idx, inputs=None, bucket=None, key=None):
        self.buckets.append(bucket)
        time.sleep(self.delay_s)
        return {"agent_id": np.asarray(rows, np.int32),
                "npv": np.asarray(rows, np.float32) * 2.0}


def test_backpressure_refuses_over_the_queue_bound():
    bat = Microbatcher(_StubEngine(), tcfg.ServeConfig(
        max_batch=8, max_wait_ms=1000.0, max_queue=2, port=0), start=False)
    f1 = bat.submit([1], year=2014)
    f2 = bat.submit([2], year=2014)
    with pytest.raises(QueueFullError, match="back off"):
        bat.submit([3], year=2014)
    assert bat.stats()["rejected"] == 1
    assert bat.stats()["queue_depth"] == 2
    bat.close()
    for f in (f1, f2):               # close fails what is queued
        with pytest.raises(RuntimeError, match="closed"):
            f.result(1.0)


def test_submit_validates_on_the_callers_thread(engine):
    bat = Microbatcher(engine, SERVE_CFG, start=False)
    try:
        with pytest.raises(KeyError, match="unknown agent_id"):
            bat.submit([10 ** 9], year=2014)
        with pytest.raises(KeyError, match="not on the model grid"):
            bat.submit([1], year=1999)
        with pytest.raises(KeyError, match="not on the model grid"):
            bat.submit([1], year=2016.7)
        with pytest.raises(ValueError, match="max_batch"):
            bat.submit(list(range(9)), year=2014)
        with pytest.raises(OverrideError, match="unknown ScenarioInputs"):
            bat.submit([1], overrides={"set": {"no_such_field": 1.0}})
        with pytest.raises(ValueError, match="empty"):
            bat.submit([], year=2014)
        with pytest.raises(tengine.QuarantinedAgentError):
            bat.submit([QID], year=2014)
        assert bat.stats()["queue_depth"] == 0
    finally:
        bat.close()


def test_concurrent_producers_lose_and_duplicate_nothing():
    """8 producer threads race 24 submits each through one batcher: every
    accepted request resolves once with its own agent's row, and the
    counts balance (tests/test_serve.py:183-247)."""
    n_threads, per_thread = 8, 24
    stub = _StubEngine(delay_s=0.002)
    bat = Microbatcher(stub, tcfg.ServeConfig(max_batch=8, min_bucket=1,
                                              max_wait_ms=5.0, max_queue=64, port=0))
    futures, fut_lock, rejections = {}, threading.Lock(), []
    barrier = threading.Barrier(n_threads)

    def produce(t):
        barrier.wait()
        for k in range(per_thread):
            aid = t * per_thread + k
            while True:
                try:
                    f = bat.submit([aid], year=2016)
                except QueueFullError:
                    rejections.append(aid)
                    time.sleep(0.002)
                    continue
                with fut_lock:
                    assert aid not in futures, f"duplicate accept {aid}"
                    futures[aid] = f
                break

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    total = n_threads * per_thread
    try:
        assert len(futures) == total
        for aid, f in futures.items():
            got = f.result(30.0)
            assert list(got["agent_id"]) == [aid]
            assert list(got["npv"]) == [2.0 * aid]
    finally:
        bat.close()
    stats = bat.stats()
    assert stats["requests"] == total and stats["rows"] == total
    assert stats["rejected"] == len(rejections)
    assert stats["queue_depth"] == 0
    assert stats["batches"] >= total // 8
    assert set(stub.buckets) <= {1, 2, 4, 8}


def test_a_serve_query_fault_fails_only_its_batch(engine):
    """The first batch hits the serve_query fault: both of its coalesced
    requests fail with it; the worker lives, and the next batch answers
    what the engine answers."""
    bat = Microbatcher(engine, tcfg.ServeConfig(max_batch=8, min_bucket=4,
                                                max_wait_ms=200.0, max_queue=8, port=0))
    try:
        with faults.injected("serve_query@1") as reg:
            f1 = bat.submit([IDS[0]], year=YEAR)
            f2 = bat.submit([IDS[1]], year=YEAR)
            for f in (f1, f2):
                with pytest.raises(faults.FaultError, match="serve_query"):
                    f.result(30.0)
            got = bat.query(IDS[:2], year=YEAR, timeout=60.0)
            assert reg.fired("serve_query") == 1
        stats = bat.stats()
        assert stats["batches"] == 1 and stats["requests"] == 3
        ref = engine.query(IDS[:2], year=YEAR, bucket=4)
        assert _same_bits(got, ref)
    finally:
        bat.close()


# ---------------------------------------------------------------------------
# Latency histograms
# ---------------------------------------------------------------------------

def test_log_histogram_percentiles_match_jax():
    values = [0.001] * 90 + [0.1] * 9 + [2.0] + [0.0, 3e-5, 1e3]
    got, ref = timing.LogHistogram(), jtiming.LogHistogram()
    for v in values:
        got.record(v)
        ref.record(v)
    assert got.counts == ref.counts
    assert got.snapshot() == ref.snapshot()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert got.percentile(q) == ref.percentile(q)
    assert timing.HIST_BOUNDS == jtiming.HIST_BOUNDS
    assert timing.LogHistogram().snapshot()["p99"] == 0.0
    timing.reset_timings()
    try:
        for ms in (1, 1, 1, 50):
            timing.observe("req", ms / 1e3, ctx="serveA")
        rep = timing.timing_report(ctx="serveA")
        assert rep["req"]["count"] == 4 and rep["req"]["p50"] <= rep["req"]["p99"]
        assert timing.timing_report(ctx="other") == {}
        assert "serveA:req" in timing.timing_report()
        assert timing.histogram("req", ctx="serveA").n == 4
    finally:
        timing.reset_timings()


# ---------------------------------------------------------------------------
# The serve config and the fault sites
# ---------------------------------------------------------------------------

ENV_CASES = [
    {},
    {"DGEN_TPU_SERVE_MAX_BATCH": "16", "DGEN_TPU_SERVE_WAIT_MS": "2.5",
     "DGEN_TPU_SERVE_QUEUE": "9", "DGEN_TPU_SERVE_WARMUP": "off"},
    {"DGEN_TPU_SERVE_HOST": "0.0.0.0", "DGEN_TPU_SERVE_PORT": "0",
     "DGEN_TPU_SERVE_REQ_TIMEOUT_S": "3", "DGEN_TPU_SERVE_SOCK_TIMEOUT_S": "4",
     "DGEN_TPU_SERVE_SURFACE": "/s", "DGEN_TPU_SERVE_CACHE_DIR": "/c",
     "DGEN_TPU_SERVE_CACHE_ENTRIES": "7"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=["defaults", "queue", "http-layers"])
def test_serve_config_from_env_matches_jax(monkeypatch, env):
    for k in [k for k in os.environ if k.startswith("DGEN_TPU_SERVE_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = dc.asdict(tcfg.ServeConfig.from_env(min_bucket=2))
    assert got == dc.asdict(jcfg.ServeConfig.from_env(min_bucket=2))
    assert tcfg.ServeConfig.from_env(min_bucket=2).buckets == \
        jcfg.ServeConfig.from_env(min_bucket=2).buckets


@pytest.mark.parametrize("bad", [dict(max_batch=12), dict(min_bucket=128),
                                 dict(max_wait_ms=-1.0), dict(max_queue=0),
                                 dict(port=70000), dict(result_cache_entries=0)])
def test_serve_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        tcfg.ServeConfig(**bad)
    with pytest.raises(ValueError):
        jcfg.ServeConfig(**bad)


def test_serving_fault_sites_are_ported_and_the_fleet_site_is_not():
    # the fleet's front_route site is ported too since the fleet is
    for site in ("serve_query", "serve_replica_kill", "serve_replica_hang",
                 "surface_load", "front_route"):
        assert site in faults.SITES and site not in faults.UNPORTED_SITES
        assert faults.parse_spec(f"{site}@2")[0].nth == 2
    assert not any("item 11" in item for item in faults.UNPORTED_SITES.values())


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def http_app(engine):
    app = ServeApp(engine, SERVE_CFG)       # warms buckets 4 and 8
    srv = start_in_thread(app)
    yield app, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    app.close()


def _request(port, method, path, body=None, conn=None, headers=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    blob = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    c.request(method, path, body=blob, headers=headers or {})
    r = c.getresponse()
    payload = r.read()
    if conn is None:
        c.close()
    return r, (json.loads(payload) if payload else None)


def test_query_rows_match_jax_rows(http_app, jax_engine, engine):
    _app, port = http_app
    r, got = _request(port, "POST", "/query", {"agent_ids": IDS, "year": YEAR,
                                               "overrides": OVR, "cash_flow": True})
    assert r.status == 200 and got["year"] == YEAR
    ref = jserver._rows_to_json(
        jax_engine.query(IDS, year=YEAR, overrides=OVR, bucket=4), True)
    assert [sorted(row) for row in got["results"]] == [sorted(row) for row in ref]
    cols = {f: np.asarray([row[f] for row in got["results"]], dtype=np.float64)
            for f in tengine.QUERY_FIELDS}
    refc = {f: np.asarray([row[f] for row in ref], dtype=np.float64)
            for f in tengine.QUERY_FIELDS}
    assert_close_to_jax(cols, refc)
    # the rows are the port's engine answer at the batch's bucket, exactly
    # (JSON carries float32 through float64 unchanged)
    assert got["results"] == rows_to_json(
        engine.query(IDS, year=YEAR, overrides=OVR, bucket=4), True)
    _r, short = _request(port, "POST", "/query", {"agent_ids": [5], "year": YEAR})
    assert "cash_flow" not in short["results"][0]


@pytest.mark.parametrize("body,code,match", [
    ({"agent_ids": [10 ** 9]}, 400, "unknown agent_id"),
    ({"agent_ids": [17.9]}, 400, "unknown agent_id"),
    ({"agent_ids": []}, 400, "non-empty"),
    ({"agent_ids": [5], "year": 1999}, 400, "not on the model grid"),
    ({"agent_ids": [5], "overrides": {"set": {"nope": 1}}}, 400, "unknown ScenarioInputs"),
    ({"agent_ids": [QID]}, 422, "quarantined"),
], ids=["unknown", "non-integral", "empty", "year", "override", "quarantined"])
def test_http_error_codes(http_app, body, code, match):
    _app, port = http_app
    r, got = _request(port, "POST", "/query", body)
    assert r.status == code and match in got["error"]
    if code == 422:
        assert got["quarantine"] == {"agent_id": QID, "reasons": ["config:quarantine_ids"]}


def test_http_keepalive_survives_refusals(http_app):
    """A POST to a bad route (body read, 404) and a refusal keep the
    connection usable; an oversize body is refused unread and closes it."""
    _app, port = http_app
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    r, _ = _request(port, "POST", "/queryy", b'{"agent_ids": [5]}', conn=conn)
    assert r.status == 404 and not r.will_close
    r, _ = _request(port, "POST", "/query", {"agent_ids": [10 ** 9]}, conn=conn)
    assert r.status == 400 and not r.will_close
    r, got = _request(port, "GET", "/nope", conn=conn)
    assert r.status == 404
    r, got = _request(port, "GET", "/healthz", conn=conn)
    assert r.status == 200 and got["n_agents"] == N_AGENTS - 1
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/query", body=b"", headers={"Content-Length": str(2 << 20)})
    r = conn.getresponse()
    assert r.status == 413 and r.will_close
    conn.close()


def test_probes_report_readiness_latency_and_no_builds(http_app):
    app, port = http_app
    _request(port, "POST", "/query", {"agent_ids": IDS[:2], "year": YEAR})
    r, ready = _request(port, "GET", "/readyz")
    assert r.status == 200 and ready["ready"] and ready["warmup_done"]
    r, h = _request(port, "GET", "/healthz")
    for k in ("git_sha", "config_hash", "backend", "n_devices", "uptime_s", "boot"):
        assert k in h
    assert h["backend"] == "cpu" and set(h["buckets"]) <= set(h["warm_buckets"])
    assert h["boot"]["kernel_library"] == {"builds": 0, "loads": 0}
    r, m = _request(port, "GET", "/metricz")
    assert r.status == 200
    assert m["requests"] >= 1 and m["batches"] >= 1
    assert 0.0 < m["batch_occupancy"] <= 1.0
    assert m["latency_ms"]["p50"] <= m["latency_ms"]["p99"]
    assert m["queue_depth"] == 0 and m["buckets"] == [4, 8]
    assert m["steady_state_compiles"] == 0


def test_full_queue_timeout_and_drain_answer_503_504(engine):
    """A batcher whose worker never runs: the first request passes its
    deadline (504), the queue it left is full (503 with Retry-After), the
    drain turns /readyz and /query to 503, and the accept loop stops."""
    cfg = tcfg.ServeConfig(max_batch=8, min_bucket=4, max_queue=1, port=0,
                           warmup=False, request_timeout_s=0.2)
    app = ServeApp(engine, cfg)
    app.batcher.close()
    app.batcher = Microbatcher(engine, cfg, start=False)
    srv = start_in_thread(app)
    port = srv.server_address[1]
    try:
        r, got = _request(port, "POST", "/query", {"agent_ids": [5]})
        assert r.status == 504
        r, got = _request(port, "POST", "/query", {"agent_ids": [5]})
        assert r.status == 503 and got["retry"] and r.getheader("Retry-After") == "1"
        app.begin_drain()
        r, got = _request(port, "POST", "/query", {"agent_ids": [5]})
        assert r.status == 503 and got["draining"]
        r, got = _request(port, "GET", "/readyz")
        assert r.status == 503 and got["draining"]
    finally:
        assert drain(app, srv, timeout=5.0)
        srv.server_close()
