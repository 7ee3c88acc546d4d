"""The host-I/O pipeline of the PyTorch port (dgen_tpu_torch/io/hostio.py),
held to the contracts of the JAX package's (tests/test_hostio.py), case
by case: async and serialized runs give the same collected arrays, the
same export files byte for byte and the same checkpoints; the meta.json
stamps, the timer buckets and the DGEN_TPU_ASYNC_IO kill switch; the
depth bound under a slow writer; worker errors (the earliest year's wins,
earlier years still complete, a failed drain keeps the loop's error, a
worker error fails the run); the drain flushing every year once; a shared
pool; plain callbacks ordered on the io thread; exporters on the split
fetch/write protocol. On the CPU the fetch stage is a copy
(``to_host``)."""

import dataclasses
import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from dgen_tpu_torch.config import RunConfig, ScenarioConfig
from dgen_tpu_torch.io import checkpoint as ckpt
from dgen_tpu_torch.io import hostio, synth
from dgen_tpu_torch.io.export import RunExporter
from dgen_tpu_torch.models import health as health_mod
from dgen_tpu_torch.models import scenario as scen
from dgen_tpu_torch.models.simulation import Simulation

CFG = ScenarioConfig(name="hostio-t", start_year=2014, end_year=2018,
                     anchor_years=())          # model years 2014/16/18


@pytest.fixture(scope="module")
def pop():
    return synth.generate_population(96, states=["DE", "CA"], seed=7, pad_multiple=32,
                                     device="cpu")


def make_sim(pop, async_io, **rc):
    inputs = scen.uniform_inputs(
        CFG, n_groups=pop.table.n_groups, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(pop.table.n_groups, 0.4, np.float32)},
        device="cpu")
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, CFG,
                      RunConfig(sizing_iters=4, async_host_io=async_io, **rc),
                      with_hourly=True, device="cpu")


def make_exporter(sim, run_dir):
    return RunExporter(str(run_dir), sim.host_agent_id, sim.host_mask, device="cpu")


@pytest.fixture(scope="module")
def ab_runs(pop, tmp_path_factory):
    """One async and one serialized run with every consumer attached
    (collect, exporter, checkpoints)."""
    td = tmp_path_factory.mktemp("hostio-ab")
    out = {}
    for tag, async_io in (("async", True), ("sync", False)):
        sim = make_sim(pop, async_io)
        res = sim.run(callback=make_exporter(sim, td / tag), collect=True,
                      checkpoint_dir=str(td / f"ckpt-{tag}"))
        out[tag] = (sim, res)
    return td, out


# ---------------------------------------------------------------------------
# Parity: async against the serialized oracle
# ---------------------------------------------------------------------------

def test_async_collect_bit_exact(ab_runs):
    _, runs = ab_runs
    (sim_a, res_a), (sim_s, res_s) = runs["async"], runs["sync"]
    assert res_a.years == res_s.years == list(CFG.model_years)
    assert set(res_a.agent) == set(res_s.agent)
    for k in res_a.agent:
        assert np.array_equal(res_a.agent[k], res_s.agent[k]), k
    assert np.array_equal(res_a.state_hourly_net_mw, res_s.state_hourly_net_mw)
    assert sim_a.hostio_stats is not None and sim_s.hostio_stats is None
    assert len(sim_a.hostio_stats["years"]) == len(res_a.years)
    assert sim_a.hostio_stats["max_depth"] >= 1
    assert sim_a.hostio_stats["d2h_bytes"] > 0
    assert sim_a.health_report == sim_s.health_report == {"breaches": {}, "clean": True}
    assert res_a.agent["new_batt_adopters"].sum() > 0


@pytest.mark.parametrize("sub", ["agent_outputs", "finance_series", "state_hourly"])
def test_async_export_files_byte_identical(ab_runs, sub):
    td, _ = ab_runs
    fa = sorted((pathlib.Path(td) / "async" / sub).glob("*.npz"))
    fs = sorted((pathlib.Path(td) / "sync" / sub).glob("*.npz"))
    assert [f.name for f in fa] == [f.name for f in fs] != []
    for a, s in zip(fa, fs):
        assert a.read_bytes() == s.read_bytes(), f"{sub}/{a.name}"


def test_async_checkpoint_restore_bit_exact(ab_runs, pop):
    td, _ = ab_runs
    n = pop.table.n_agents
    for year in CFG.model_years:
        _, ca = ckpt.restore_year(str(td / "ckpt-async"), n, year, device="cpu")
        _, cs = ckpt.restore_year(str(td / "ckpt-sync"), n, year, device="cpu")
        ba = (td / "ckpt-async" / str(year) / ckpt.CARRY_FILE).read_bytes()
        assert ba == (td / "ckpt-sync" / str(year) / ckpt.CARRY_FILE).read_bytes()
        assert torch.equal(ca.market.system_kw_cum, cs.market.system_kw_cum)


def test_meta_stamps_async_provenance(ab_runs):
    td, _ = ab_runs
    meta_a = json.loads((pathlib.Path(td) / "async" / "meta.json").read_text())
    meta_s = json.loads((pathlib.Path(td) / "sync" / "meta.json").read_text())
    assert meta_a["async_io"] is True and meta_s["async_io"] is False
    assert sorted(meta_a["host_io_wall"]) == [str(y) for y in CFG.model_years]
    assert 0.0 <= meta_a["overlap_efficiency"] <= 1.0
    assert "host_blocked_s" in meta_a and "host_io_s" in meta_a
    assert not (pathlib.Path(td) / "async" / "meta.json.tmp").exists()


def test_timer_buckets_recorded(ab_runs):
    from dgen_tpu_torch.utils import timing

    report = timing.timing_report()
    for bucket in ("d2h_fetch", "export_write", "ckpt_save", "collect_host",
                   "health_check", "year_step", "device_drain"):
        assert report.get(bucket, {}).get("count", 0) >= 1, bucket


def test_env_kill_switch_forces_serialized(pop, monkeypatch):
    monkeypatch.setenv("DGEN_TPU_ASYNC_IO", "0")
    assert RunConfig().async_io_enabled is False
    # from_env does not bake the switch in: it is read at run time
    assert RunConfig.from_env().async_host_io is None
    assert RunConfig.from_env().async_io_enabled is False
    sim = make_sim(pop, async_io=None)
    sim.run(collect=True)
    assert sim.hostio_stats is None
    assert RunConfig(async_host_io=True).async_io_enabled is True
    monkeypatch.setenv("DGEN_TPU_ASYNC_IO", "1")
    assert RunConfig().async_io_enabled is True


def test_debug_invariants_and_no_consumer_serialize(pop):
    sim = make_sim(pop, async_io=True, debug_invariants=True)
    sim.run(collect=True)
    assert sim.hostio_stats is None
    sim = make_sim(pop, async_io=True)
    res = sim.run(collect=False)
    assert sim.hostio_stats is None and res.agent == {}
    assert sim.health_report["clean"]


# ---------------------------------------------------------------------------
# Pipeline mechanics (no simulation)
# ---------------------------------------------------------------------------

class Recorder:
    """Minimal consumer: records years in consume order."""

    name = "rec"
    timer_name = "export_write"
    needs_device = False

    def __init__(self, delay=0.0, fail_on=None):
        self.delay = delay
        self.fail_on = fail_on
        self.years = []
        self.finalized = None

    def device_payload(self, year, year_idx, outs, carry):
        return {"x": outs}

    def consume(self, year, year_idx, host, outs):
        if self.delay:
            time.sleep(self.delay)
        if self.fail_on is not None and year == self.fail_on:
            raise RuntimeError(f"writer died at year {year}")
        self.years.append(int(year))

    def finalize(self, stats, failed):
        self.finalized = bool(failed)


def _t(y):
    return torch.tensor(float(y))


def test_depth_for_bytes_bounds():
    assert hostio.depth_for_bytes(1, budget=10) == 10
    assert hostio.depth_for_bytes(4, budget=10) == 2
    assert hostio.depth_for_bytes(10**12) == 1


def test_bounded_depth_under_slow_writer():
    rec = Recorder(delay=0.05)
    p = hostio.HostPipeline([rec], max_in_flight=2)
    t0 = time.perf_counter()
    for y in range(6):
        p.submit(y, y, _t(y))
    submit_wall = time.perf_counter() - t0
    stats = p.drain()
    assert rec.years == list(range(6))
    assert stats["max_depth"] <= 2
    assert submit_wall > 0.05
    assert stats["host_blocked_s"] > 0.0
    assert rec.finalized is False


def test_worker_exception_surfaces_never_silently():
    rec = Recorder(fail_on=1)
    p = hostio.HostPipeline([rec], max_in_flight=1)
    with pytest.raises(RuntimeError, match="writer died at year 1"):
        try:
            for y in range(5):
                p.submit(y, y, _t(y))
        finally:
            p.drain()
    assert rec.years == [0]
    assert rec.finalized is True


class Gated(Recorder):
    def __init__(self, gate, **kw):
        super().__init__(**kw)
        self.gate = gate

    def consume(self, year, year_idx, host, outs):
        self.gate.wait(5.0)
        super().consume(year, year_idx, host, outs)


@pytest.mark.parametrize("fail_on,match,done", [
    (None, "boom", [0, 1, 2]),                     # earlier years still complete
    (1, "writer died at year 1", [0]),             # the earliest year's error wins
], ids=["late_year_error", "earliest_year_error_wins"])
def test_year_errors(fail_on, match, done):
    """A later year's fetch error must not skip earlier years queued on
    the io thread; an earlier year's own failure supersedes it and gates
    every later year."""
    gate = threading.Event()
    rec = Gated(gate, fail_on=fail_on)
    p = hostio.HostPipeline([rec], max_in_flight=4)
    for y in range(4):
        p.submit(y, y, _t(y))
    p._record_error(3, RuntimeError("boom"), 3)
    gate.set()
    with pytest.raises(RuntimeError, match=match):
        p.drain()
    assert rec.years == done
    assert rec.finalized is True


def test_failed_drain_preserves_original_error():
    rec = Recorder(fail_on=0)
    p = hostio.HostPipeline([rec], max_in_flight=1)
    p.submit(0, 0, _t(0))
    stats = p.drain(failed=True)           # must not raise
    assert stats["max_depth"] == 1
    assert rec.finalized is True


def test_drain_flushes_all_queued_years_exactly_once():
    rec = Recorder()
    p = hostio.HostPipeline([rec], max_in_flight=4)
    for y in range(3):
        p.submit(y, y, _t(y))
    p.drain(failed=True)
    assert rec.years == [0, 1, 2]
    p.drain()
    assert rec.years == [0, 1, 2]


def test_shared_pool_not_closed_by_pipeline():
    pool = hostio.HostIOPool()
    try:
        r1, r2 = Recorder(), Recorder()
        p1 = hostio.HostPipeline([r1], max_in_flight=1, pool=pool)
        p1.submit(0, 0, _t(0))
        p1.drain()
        p2 = hostio.HostPipeline([r2], max_in_flight=1, pool=pool)
        p2.submit(1, 1, _t(1))
        p2.drain()
        assert r1.years == [0] and r2.years == [1]
    finally:
        pool.close()


def test_plain_callback_runs_ordered_on_io_thread():
    seen = []
    main = threading.get_ident()

    def cb(year, year_idx, outs):
        seen.append((int(year), threading.get_ident()))

    c = hostio.consumer_for_callback(cb)
    assert isinstance(c, hostio.CallbackConsumer)
    p = hostio.HostPipeline([c], max_in_flight=2)
    for y in range(4):
        p.submit(y, y, _t(y))
    p.drain()
    assert [y for y, _ in seen] == list(range(4))
    assert all(tid != main for _, tid in seen)


def test_exporter_gets_split_fetch_protocol(pop, tmp_path):
    sim = make_sim(pop, async_io=True)
    assert isinstance(hostio.consumer_for_callback(make_exporter(sim, tmp_path / "r")),
                      hostio.ExportConsumer)


def test_to_host_copies_every_tensor_of_a_nest():
    a, b = torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.tensor(3, dtype=torch.int16)
    nest = {"x": [a, (b, None)], "n": 4}
    host = hostio.to_host(nest)
    assert isinstance(host["x"][0], np.ndarray) and host["x"][1][1] is None
    assert host["n"] == 4 and host["x"][1][0].dtype == np.int16
    a.add_(1.0)   # a copy: the source's later writes do not show
    np.testing.assert_array_equal(host["x"][0], np.arange(6).reshape(2, 3))
    assert hostio.tree_bytes(nest) == 6 * 4 + 2


# ---------------------------------------------------------------------------
# Failure-path semantics through Simulation.run
# ---------------------------------------------------------------------------

def test_loop_failure_flushes_completed_years_once(pop, monkeypatch):
    calls = []

    def cb(year, year_idx, outs):
        calls.append(int(year))

    sim = make_sim(pop, async_io=True)
    orig = Simulation.step

    def bad_step(self, carry, year_idx, first_year):
        if year_idx == 2:
            raise RuntimeError("device fell over")
        return orig(self, carry, year_idx, first_year)

    monkeypatch.setattr(Simulation, "step", bad_step)
    with pytest.raises(RuntimeError, match="device fell over"):
        sim.run(callback=cb, collect=False)
    assert calls == list(CFG.model_years[:2])


def test_worker_error_fails_the_run(pop):
    def cb(year, year_idx, outs):
        raise OSError("disk full")

    sim = make_sim(pop, async_io=True)
    with pytest.raises(OSError, match="disk full"):
        sim.run(callback=cb, collect=False)


def test_health_breach_gates_the_year_export(pop, tmp_path, monkeypatch):
    """The sentinel runs first on the io thread: an escalated breach in
    year 2 fails the run, year 1 is written and year 2 is not."""
    sim = make_sim(pop, async_io=True, sentinel_escalate=True)
    orig = Simulation.step

    def poisoned(self, carry, year_idx, first_year):
        carry, outs = orig(self, carry, year_idx, first_year)
        if year_idx == 1:
            npv = outs.npv.clone()
            npv[3] = float("nan")
            outs = dataclasses.replace(outs, npv=npv)
        return carry, outs

    monkeypatch.setattr(Simulation, "step", poisoned)
    with pytest.raises(health_mod.HealthBreachError) as err:
        sim.run(callback=make_exporter(sim, tmp_path / "run"), collect=False)
    assert err.value.year == 2016 and err.value.agent_ids == (int(sim.host_agent_id[3]),)
    assert sorted(os.listdir(tmp_path / "run" / "agent_outputs")) == ["year=2014.npz"]
