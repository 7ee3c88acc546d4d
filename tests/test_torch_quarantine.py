"""Bad-data quarantine and the sentinel's escalation in the PyTorch port
(``dgen_tpu_torch.resilience.quarantine``, ``models.health`` and the
supervisor's breach -> attribute -> quarantine -> resume loop), held
against the JAX package's (``tests/test_quarantine.py``, case by case,
without the serve case).

The same seeded populations, corrupted with numpy, go through both
packages (carried across with ``dgen_tpu_torch.convert``): the reports
(ids, rows, reasons, bank rows, ``summary()``, ``to_json()``) and the
rewritten columns must be equal, exactly. The port's plain bucket sums
put NaN where the JAX package's XLA engine puts it.
"""

import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu.ops import billpallas as jbp
from dgen_tpu.resilience import faults as jfaults
from dgen_tpu.resilience import quarantine as jq
from dgen_tpu.resilience import supervisor as jsup
from dgen_tpu_torch import convert
from dgen_tpu_torch.config import RunConfig, ScenarioConfig
from dgen_tpu_torch.io import export as texport
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import health as thealth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.simulation import SimCarry, Simulation
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.resilience import faults
from dgen_tpu_torch.resilience import quarantine as tq
from dgen_tpu_torch.resilience import supervisor as tsup

N = 24
STATES = ["DE", "CA"]
#: the slice's tolerance (tests/test_torch_slice.py)
RTOL = 1e-3



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small model years: beside
    the suite's other worker processes, more threads only contend (their
    serial seconds fell ~2.4x in a three-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpop(seed=11, n=N):
    return jsynth.generate_population(n, states=STATES, seed=seed, pad_multiple=64)


def _port(jtable, jprofiles=None, jtariffs=None):
    """The port's containers of JAX (or numpy-rebuilt) containers."""
    t = convert.agent_table(convert.to_numpy_dict(jtable), device="cpu")
    p = (convert.profile_bank(convert.to_numpy_dict(jprofiles), device="cpu")
         if jprofiles is not None else None)
    b = (convert.tariff_bank(convert.to_numpy_dict(jtariffs), device="cpu")
         if jtariffs is not None else None)
    return t, p, b


def _tpop(n=N):
    return tsynth.generate_population(n, states=STATES, seed=11, pad_multiple=64,
                                      device="cpu")


def _cfg(end_year=2016):
    return ScenarioConfig(name="q", start_year=2014, end_year=end_year, anchor_years=())


def _make_sim(pop, cfg, rc=None, **kw):
    """A port Simulation of ``pop`` on the CPU (a 5-year cash-flow horizon:
    the plain bucket sums scale with it)."""
    inputs = tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions, device="cpu")
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      rc or RunConfig(sizing_iters=4), econ_years=5, device="cpu",
                      **kw)


def _same_report(t, j):
    assert t.ids == j.ids
    assert t.records == j.records
    assert t.bank_rows == j.bank_rows
    assert t.summary() == j.summary()
    assert t.to_json() == j.to_json()
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_containers(t, j):
    for f in dataclasses.fields(type(t)):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            _same_containers(a, b)
        elif isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(_host(a), _host(b), err_msg=f.name)
            assert _host(a).dtype == _host(b).dtype, f.name


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_clean_population_validates_clean():
    jp = _jpop()
    rep = tq.validate_population(*_port(jp.table, jp.profiles, jp.tariffs))
    assert rep.is_clean and rep.n_agents == N
    assert rep.summary()["n_quarantined"] == 0
    _same_report(rep, jq.validate_population(jp.table, jp.profiles, jp.tariffs))


def _corrupt(kind: str):
    """(JAX table, profiles, tariffs) with one seeded corruption."""
    jp = _jpop()
    t, p, b = jp.table, jp.profiles, jp.tariffs
    col = lambda c: np.array(np.asarray(getattr(t, c)))
    if kind == "columns":
        cust, lk, ti = col("customers_in_bin"), col("load_kwh_per_customer_in_bin"), \
            col("tariff_idx")
        cust[5] = np.nan
        lk[7] = -1e4                       # negative load
        ti[9] = 999999                     # out-of-range tariff
        t = dataclasses.replace(t, customers_in_bin=jnp.asarray(cust),
                                load_kwh_per_customer_in_bin=jnp.asarray(lk),
                                tariff_idx=jnp.asarray(ti))
    elif kind == "bank_row":
        load = np.array(np.asarray(p.load))
        load[2] = np.nan
        p = dataclasses.replace(p, load=jnp.asarray(load))
    elif kind == "quant_scale":
        codes, scales = [], []
        for bank in (p.load, p.solar_cf):
            a = np.asarray(bank, np.float32)
            amax = np.max(np.abs(a), axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            codes.append(np.clip(np.rint(a / s[:, None]), -127, 127).astype(np.int8))
            scales.append(s)
        scales[0][1] = np.nan
        scales[1][0] = 0.0                 # zero scale under nonzero codes
        p = dataclasses.replace(p, load=jnp.asarray(codes[0]),
                                solar_cf=jnp.asarray(codes[1]),
                                load_scale=jnp.asarray(scales[0]),
                                solar_cf_scale=jnp.asarray(scales[1]))
    elif kind == "tariff_and_incentives":
        price = np.array(np.asarray(b.price))
        price[3, 0, 0] = -0.1              # negative buy price
        fixed = np.array(np.asarray(b.fixed_monthly))
        fixed[1] = np.inf
        b = dataclasses.replace(b, price=jnp.asarray(price),
                                fixed_monthly=jnp.asarray(fixed))
        cbi = np.array(np.asarray(t.incentives.cbi_usd_p_w))
        cbi[11, 1] = np.nan
        wh = np.array(np.asarray(p.wholesale))
        wh[0, 100] = np.nan
        t = dataclasses.replace(t, incentives=dataclasses.replace(
            t.incentives, cbi_usd_p_w=jnp.asarray(cbi)))
        p = dataclasses.replace(p, wholesale=jnp.asarray(wh))
    return t, p, b


@pytest.mark.parametrize("kind", ["columns", "bank_row", "quant_scale",
                                  "tariff_and_incentives"])
def test_reports_and_rewritten_columns_equal_the_jax_package(kind):
    jt, jp, jb = _corrupt(kind)
    tt, tp, tb = _port(jt, jp, jb)
    jrep = jq.validate_population(jt, jp, jb)
    trep = tq.validate_population(tt, tp, tb)
    assert not jrep.is_clean
    _same_report(trep, jrep)
    jt2, jp2 = jq.apply_quarantine(jt, jp, jrep)
    tt2, tp2 = tq.apply_quarantine(tt, tp, trep)
    _same_containers(tt2, jt2)
    _same_containers(tp2, jp2)


def test_validation_flags_nonfinite_and_bad_references():
    jt, jp, jb = _corrupt("columns")
    rep = tq.validate_population(*_port(jt, jp, jb))
    assert rep.ids == (5, 7, 9)
    assert "nonfinite:customers_in_bin" in rep.reasons_for(5)
    assert "range:load_kwh_per_customer_in_bin" in rep.reasons_for(7)
    assert "index:tariff_idx" in rep.reasons_for(9)
    # padding rows are never validated
    assert all(r["row"] < jt.n_agents for r in rep.records.values())


def test_validation_flags_bad_bank_row_and_referencing_agents():
    jt, jp, jb = _corrupt("bank_row")
    tt, tp, tb = _port(jt, jp, jb)
    rep = tq.validate_population(tt, tp, tb)
    assert rep.bank_rows["load"] == [2]
    keep = _host(tt.mask) > 0
    expected = sorted(int(a) for a in _host(tt.agent_id)[keep & (_host(tt.load_idx) == 2)])
    assert list(rep.ids) == expected and expected
    for a in expected:
        assert "bank:load[2]" in rep.reasons_for(a)


def test_quant_sidecar_zero_scale_all_zero_row_is_valid():
    codes = np.zeros((3, 8), np.int8)
    codes[1, :] = 5
    for scales, bad in (([0.0, 2.0, 1.0], []), ([0.0, 0.0, 1.0], [1]),
                        ([np.nan, 2.0, -1.0], [0, 2])):
        s = np.asarray(scales, np.float32)
        got = tq.quant_sidecar_bad_rows(torch.from_numpy(codes), torch.from_numpy(s))
        assert got.tolist() == bad == jq.quant_sidecar_bad_rows(codes, s).tolist()


def test_validation_refuses_wholesale_corruption_masquerade(monkeypatch):
    jp = _jpop()
    cust = np.array(np.asarray(jp.table.customers_in_bin))
    cust[:] = np.nan
    bad = dataclasses.replace(jp.table, customers_in_bin=jnp.asarray(cust))
    monkeypatch.setattr(tq, "MAX_QUARANTINE", 10)
    monkeypatch.setattr(jq, "MAX_QUARANTINE", 10)
    with pytest.raises(ValueError, match="refusing") as te:
        tq.validate_population(*_port(bad, jp.profiles, jp.tariffs))
    with pytest.raises(ValueError, match="refusing") as je:
        jq.validate_population(bad, jp.profiles, jp.tariffs)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# containment
# ---------------------------------------------------------------------------

def test_apply_quarantine_clean_report_is_identity():
    pop = _tpop()
    rep = tq.QuarantineReport(n_agents=N)
    t2, p2 = tq.apply_quarantine(pop.table, pop.profiles, rep)
    assert t2 is pop.table and p2 is pop.profiles


def test_apply_quarantine_makes_rows_inert_padding():
    jp = _jpop()
    tt, tp, _ = _port(jp.table, jp.profiles)
    rep = tq.QuarantineReport(n_agents=N)
    rep.add(4, 4, "test")
    rep.add_bank_row("load", 1)
    t2, p2 = tq.apply_quarantine(tt, tp, rep)
    assert _host(t2.mask)[4] == 0.0
    assert _host(t2.agent_id)[4] == 4          # id preserved
    assert _host(t2.customers_in_bin)[4] == 0.0
    assert _host(t2.nem_kw_limit)[4] >= 1e29   # pad fill
    assert _host(t2.switch_min_kw)[4] >= 1e29
    assert _host(t2.tariff_idx)[4] == 0
    assert np.all(_host(p2.load)[1] == 0.0)
    jrep = jq.QuarantineReport(n_agents=N)
    jrep.add(4, 4, "test")
    jrep.add_bank_row("load", 1)
    jt2, jp2 = jq.apply_quarantine(jp.table, jp.profiles, jrep)
    _same_containers(t2, jt2)
    _same_containers(p2, jp2)


def test_report_roundtrips_through_json_and_reads_the_jax_file(tmp_path):
    rep = tq.QuarantineReport(n_agents=5, context="load")
    rep.add(3, 3, "nonfinite:customers_in_bin")
    rep.add(3, 3, "index:tariff_idx")
    rep.add_bank_row("load", 2)
    p = str(tmp_path / "quarantine.json")
    rep.save(p)
    back = tq.QuarantineReport.load(p)
    assert back.ids == (3,) and back.reasons_for(3) == rep.reasons_for(3)
    assert back.bank_rows == {"load": [2]} and back.n_agents == 5
    # a quarantine.json the JAX package wrote
    jt, jpr, jb = _corrupt("bank_row")
    jrep = jq.validate_population(jt, jpr, jb)
    jp = str(tmp_path / "jax_quarantine.json")
    jrep.save(jp)
    _same_report(tq.QuarantineReport.load(jp), jrep)


def test_ingest_corruption_contained_bit_exact_vs_prequarantined():
    """A corrupted-then-quarantined run equals, bit for bit, a clean run
    with the same rows quarantined: the corrupt values reached nothing
    that survived."""
    pop = _tpop()
    with faults.injected("ingest_corrupt_row@1:corrupt") as reg:
        pop_c = _tpop()
    assert reg.fired("ingest_corrupt_row") == 1
    cfg = _cfg(end_year=2014)
    sim_c = _make_sim(pop_c, cfg)
    assert sim_c.quarantine_report.ids == (3, 17)
    res_c = sim_c.run()
    sim_b = _make_sim(pop, cfg, quarantine=sim_c.quarantine_report)
    res_b = sim_b.run()
    for k in res_c.agent:
        np.testing.assert_array_equal(res_c.agent[k], res_b.agent[k], err_msg=k)


def test_jax_and_port_simulations_agree_on_a_corrupt_population():
    """The JAX package's ingest corruption, carried across: both
    Simulations quarantine the same rows with the same reasons, and their
    outputs agree within the slice's tolerance."""
    with jfaults.injected("ingest_corrupt_row@1:corrupt"):
        jp = _jpop()
    jcfg_ = jcfg.ScenarioConfig(name="q", start_year=2014, end_year=2016,
                                anchor_years=())
    jin = jscen.uniform_inputs(jcfg_, n_groups=jp.table.n_groups, n_regions=jp.n_regions)
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs, jin, jcfg_,
                       jcfg.RunConfig(sizing_iters=4))
    tt, tp, tb = _port(jp.table, jp.profiles, jp.tariffs)
    cfg = _cfg()
    tin = tscen.uniform_inputs(cfg, n_groups=tt.n_groups, n_regions=jp.n_regions,
                               device="cpu")
    tsim = Simulation(tt, tp, tb, tin, cfg, RunConfig(sizing_iters=4), device="cpu")
    _same_report(tsim.quarantine_report, jsim.quarantine_report)
    assert tsim.quarantine_report.ids == (3, 17)
    jres, tres = jsim.run(), tsim.run()
    # the real rows: a quarantined row is padding, whose outputs are inert
    # and are compared by neither package
    keep = tsim.host_mask > 0
    np.testing.assert_array_equal(keep, np.asarray(jsim.host_mask) > 0)
    assert not keep[[3, 17]].any()
    for k, ref in jres.agent.items():
        ref, got = ref[:, keep], tres.agent[k][:, keep]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4 * scale, err_msg=k)
        assert np.isfinite(got).all(), k


def test_quarantine_ids_config_round_trip():
    pop = _tpop()
    sim = _make_sim(pop, _cfg(), rc=RunConfig(sizing_iters=4, quarantine_ids=(2, 11)))
    assert set(sim.quarantine_report.ids) == {2, 11}
    assert "config:quarantine_ids" in sim.quarantine_report.reasons_for(2)
    assert _host(sim.table.mask)[2] == 0.0


def test_validate_kill_switch(monkeypatch):
    monkeypatch.setenv("DGEN_TPU_VALIDATE", "0")
    assert not RunConfig().validate_enabled
    assert not jcfg.RunConfig().validate_enabled
    monkeypatch.setenv("DGEN_TPU_SENTINEL", "0")
    assert not RunConfig().sentinel_enabled
    monkeypatch.delenv("DGEN_TPU_VALIDATE")
    monkeypatch.delenv("DGEN_TPU_SENTINEL")
    assert RunConfig().validate_enabled and RunConfig().sentinel_enabled
    assert RunConfig(validate_inputs=False).validate_enabled is False
    # a default Simulation validates its inputs, as the JAX one does
    pop = _tpop()
    assert _make_sim(pop, _cfg()).quarantine_report.is_clean
    monkeypatch.setenv("DGEN_TPU_VALIDATE", "0")
    assert _make_sim(pop, _cfg()).quarantine_report is None


def test_clean_inputs_keep_their_tensors():
    """Validation of a clean population changes nothing: the Simulation
    holds the very tensors it would hold without it."""
    pop = _tpop()
    on = _make_sim(pop, _cfg())
    off = _make_sim(pop, _cfg(), rc=RunConfig(sizing_iters=4, validate_inputs=False))
    assert on.quarantine_report.is_clean
    for f in dataclasses.fields(type(on.table)):
        a, b = getattr(on.table, f.name), getattr(off.table, f.name)
        if isinstance(a, torch.Tensor):
            assert a.data_ptr() == b.data_ptr(), f.name
    assert on.profiles.load.data_ptr() == off.profiles.load.data_ptr()


def test_sanitize_restored_carry_zeroes_exactly_the_quarantined_rows():
    pop = _tpop()
    sim = _make_sim(pop, _cfg(), rc=RunConfig(sizing_iters=4, quarantine_ids=(2, 11)))
    n = sim.table.n_agents
    rng = np.random.default_rng(0)
    carry = SimCarry.zeros(n, "cpu")
    carry = dataclasses.replace(
        carry,
        market=type(carry.market)(**{
            f.name: torch.from_numpy(rng.random(n, dtype=np.float32) + 1.0)
            for f in dataclasses.fields(carry.market)}),
        batt_adopters_cum=torch.from_numpy(rng.random(n, dtype=np.float32) + 1.0))
    out = sim._sanitize_restored_carry(carry)
    ids = _host(sim.table.agent_id)
    q = np.isin(ids, [2, 11])
    for name, leaf in (("batt", out.batt_adopters_cum),
                       *((f.name, getattr(out.market, f.name))
                         for f in dataclasses.fields(out.market))):
        v = _host(leaf)
        assert (v[q] == 0).all() and (v[~q] >= 1.0).all(), name
    clean = _make_sim(pop, _cfg())
    assert clean._sanitize_restored_carry(carry) is carry


# ---------------------------------------------------------------------------
# the health sentinel's escalation
# ---------------------------------------------------------------------------

def _expected_bank_ids(pop, row=3):
    keep = _host(pop.table.mask) > 0
    li = _host(pop.table.load_idx)
    return sorted(int(a) for a in _host(pop.table.agent_id)[keep & (li == row)])


@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_sentinel_breach_attributes_exactly(async_io):
    """Mid-run bank corruption: the breach names the year and exactly the
    referencing agents, on the serialized path and on the pipeline."""
    pop = _tpop()
    rc = RunConfig(sizing_iters=4, sentinel_escalate=True, async_host_io=async_io)
    sim = _make_sim(pop, _cfg(), rc=rc)
    with faults.injected("bank_corrupt_row@2:corrupt"):
        with pytest.raises(thealth.HealthBreachError) as ei:
            sim.run(collect=True)
    err = ei.value
    assert err.year == 2016
    assert list(err.agent_ids) == _expected_bank_ids(pop)
    assert any(b["leaf"] == "npv" for b in err.breaches)
    assert sim._health_breaches


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_sentinel_warn_only_by_default():
    pop = _tpop()
    sim = _make_sim(pop, _cfg(), rc=RunConfig(sizing_iters=4, async_host_io=False))
    h = _Capture()
    logging.getLogger("dgen_tpu_torch").addHandler(h)
    try:
        with faults.injected("bank_corrupt_row@2:corrupt"):
            sim.run()
    finally:
        logging.getLogger("dgen_tpu_torch").removeHandler(h)
    assert not sim.health_report["clean"]
    assert 2016 in sim.health_report["breaches"]
    assert any("health sentinel" in m for m in h.messages)


def test_classify_and_degrade_health_equal_the_jax_package():
    from dgen_tpu.models.health import HealthBreachError as JBreach

    args = (2016, 1, [{"leaf": "npv", "nonfinite": 3, "out_of_bounds": 0}])
    kw = dict(agent_rows=(4, 7), agent_ids=(4, 7))
    terr, jerr = thealth.HealthBreachError(*args, **kw), JBreach(*args, **kw)
    assert tsup.classify_error(terr) == jsup.classify_error(jerr) == tsup.HEALTH
    out = []
    for sup, rc, err in ((tsup, RunConfig(quarantine_ids=(2,)), terr),
                         (jsup, jcfg.RunConfig(quarantine_ids=(2,)), jerr)):
        s = sup.Supervisor()
        ctx = sup.AttemptContext(attempt=0, run_config=rc, resume=False)
        rc2, desc, give_up = s._degrade(rc, sup.HEALTH, ctx, 0, exc=err)
        _, _, give_up2 = s._degrade(rc2, sup.HEALTH, ctx, 0, exc=err)
        out.append((rc2.quarantine_ids, desc, give_up, give_up2))
    assert out[0] == out[1]
    assert out[0][0] == (2, 4, 7) and "quarantined 2 agent(s)" in out[0][1]
    assert out[0][2:] == (False, True)


def test_supervised_breach_quarantines_and_recovers(tmp_path):
    """Mid-run corruption -> breach -> attributed quarantine -> resume
    from the last checkpoint -> a clean finish, quarantine.json and
    meta.json stamped, the manifest verifying."""
    from dgen_tpu_torch.resilience.manifest import verify_run_dir

    pop = _tpop()
    cfg = _cfg(end_year=2018)

    def make_sim(rc):
        return _make_sim(pop, cfg, rc=dataclasses.replace(rc, sizing_iters=4))

    run_dir = str(tmp_path / "run")
    with faults.injected("bank_corrupt_row@3:corrupt") as reg:
        _, report = tsup.run_supervised(make_sim, RunConfig(), run_dir=run_dir,
                                        collect=False)
    assert reg.fired("bank_corrupt_row") == 1
    assert report.succeeded and report.retries >= 1
    assert any("health: quarantined" in d for d in report.degradations)
    expected = _expected_bank_ids(pop)
    with open(os.path.join(run_dir, "quarantine.json")) as f:
        q = json.load(f)
    assert sorted(int(a) for a in q["agents"]) == expected
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["quarantine"]["n_quarantined"] == len(expected)
    assert "config:quarantine_ids" in meta["quarantine"]["reasons"]
    with np.load(os.path.join(run_dir, "agent_outputs", "year=2016.npz")) as z:
        assert not np.isin(expected, z["agent_id"]).any()
    assert all(r.ok for r in verify_run_dir(run_dir))


def test_export_stamp_quarantine_merges_with_the_nonfinite_breakdown(tmp_path):
    n = 6
    ex = texport.RunExporter(str(tmp_path / "run"), agent_id=np.arange(n),
                             mask=np.ones(n, np.float32), compact=True, device="cpu")
    dirty = torch.tensor([1.0, np.nan, 2.0, np.inf, -np.inf, 3.0])
    ex._local_fields([dirty, torch.arange(n, dtype=torch.float32)], quant=(True, True),
                     names=("npv", "system_kw"), year=2016)
    ex._flush_meta()
    ex.stamp_quarantine({"n_quarantined": 2, "reasons": {"x": 2}})
    with open(tmp_path / "run" / "meta.json") as f:
        meta = json.load(f)
    assert meta["quarantine"]["n_quarantined"] == 2
    assert meta["quarantine"]["nonfinite_zeroed_by_field"] == {"npv": 3}


# ---------------------------------------------------------------------------
# NaN through the bucket sums: the port's plain versions and the JAX engine
# ---------------------------------------------------------------------------

def test_plain_bucket_sums_put_nan_where_the_jax_engine_does():
    """One agent's load NaN on a few hours, another's +Inf on one: the
    port's plain ``import_sums`` and ``bucket_sums`` are non-finite in
    the same (agent, scale) rows as the JAX package's XLA engine, and in
    the same [N, R] sell sums and credits with the same kind (NaN or Inf);
    equal elsewhere within the engines' tolerance. Inside a row the port,
    as its kernels, keeps a non-finite hour in its own (month, period)
    bucket; the XLA engine's month one-hot product spreads it over its
    period's months (and the TPU kernel's period masks over its month's
    periods), so buckets are compared by row."""
    rng = np.random.default_rng(3)
    n, r, p = 6, 5, 2
    hours = 8760
    load = rng.random((n, hours), dtype=np.float32)
    gen = rng.random((n, hours), dtype=np.float32) * 0.5
    sell = rng.random((n, hours), dtype=np.float32) * 0.1
    period = rng.integers(0, p, (n, hours)).astype(np.int32)
    month = np.repeat(np.arange(12), [744, 672, 744, 720, 744, 720, 744, 744, 720,
                                      744, 720, 744])
    bucket = (month[None, :] * p + period).astype(np.int32)
    scales = rng.random((n, r), dtype=np.float32) * 2.0
    bad = {(1, 5): np.nan, (1, 900): np.nan, (1, 4000): np.nan, (4, 2000): np.inf}
    for (a, h), v in bad.items():
        load[a, h] = v
    t = [torch.from_numpy(x) for x in (load, gen, sell, bucket, scales)]
    j = [jnp.asarray(x) for x in (load, gen, sell, bucket, scales)]
    got = bk.import_sums(*t, 12 * p) + bk.bucket_sums(*t, 12 * p)
    ref = jbp.import_sums(*j, 12 * p, impl="xla") + jbp.bucket_sums(*j, 12 * p,
                                                                      impl="xla")
    for g, e in zip(got, ref):
        g, e = _host(g), np.asarray(e)
        if g.ndim == 3:
            np.testing.assert_array_equal(~np.isfinite(g).all(axis=2),
                                          ~np.isfinite(e).all(axis=2))
            # the port: exactly the buckets of the non-finite hours
            want = np.zeros(g.shape, bool)
            for (a, h) in bad:
                want[a, :, bucket[a, h]] = True
            np.testing.assert_array_equal(~np.isfinite(g), want)
        else:
            for kind in (np.isnan, np.isposinf, np.isneginf):
                np.testing.assert_array_equal(kind(g), kind(e))
        assert (~np.isfinite(g)).any()
        fin = np.isfinite(e) & np.isfinite(g)
        np.testing.assert_allclose(g[fin], e[fin], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the full drill (slow tier, as the JAX package's)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_full_quarantine_drill(tmp_path):
    from dgen_tpu_torch.resilience.quarantinedrill import run_quarantine_drill

    rec = run_quarantine_drill(str(tmp_path), n_agents=96, device="cpu")
    assert rec["ok"], json.dumps(rec, indent=1)
    assert set(rec["rounds"]) == {"ingest", "bank", "sentinel"}
    assert rec["rounds"]["ingest"]["npz_bit_exact"]
    assert rec["rounds"]["sentinel"]["retries"] >= 1
