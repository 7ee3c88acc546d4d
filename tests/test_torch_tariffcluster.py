"""Tariff clustering in the port (dgen_tpu_torch.ops.tariffcluster and
the clustered year of dgen_tpu_torch.models.simulation) against the JAX
package: the corpus analysis, the compact banks and the cluster-major
layout equal to dgen_tpu.ops.tariffcluster's exactly (n_dev 1, 2 and
4), the report and its CLI; then the single-process cases of
tests/test_tariffcluster.py on the port (clustered against unclustered
at rtol = atol = 1e-5, quarantined rows inert, the rate-switch call
refused and the rate-switch build left unclustered), a clustered port
run against a clustered JAX run at tests/test_torch_slice.py's
tolerance, clustered chunked equal to clustered whole bit for bit, a
clustered resume bit for bit (and one under another layout, moved by
agent id, across a failed attempt under that layout; a checkpoint of
the other layout kind refused), and DGEN_TPU_CLUSTER through
RunConfig.from_env.

The 2x4 mesh case waits for multi-device layouts, and the retrace guard
case for the port's guard."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models import synth as jns
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu.ops import tariffcluster as jtc
from dgen_tpu.ops.tariff import compile_tariffs as jcompile
from dgen_tpu_torch.config import RunConfig, ScenarioConfig
from dgen_tpu_torch.io import synth
from dgen_tpu_torch.models import scenario as scen
from dgen_tpu_torch.models import synth as tns
from dgen_tpu_torch.models.simulation import Simulation, year_step
from dgen_tpu_torch.ops import tariffcluster as tc
from dgen_tpu_torch.ops.tariff import NET_BILLING, NET_METERING, compile_tariffs

N = 96
STATES = ("DE", "CA", "TX")
#: the filler rows of a CPU run stay few: segments pad to 16 rows
PAD = 16
CORPORA = {
    "synth": synth.make_tariff_specs,
    "mixed": lambda: tns.make_national_tariffs("mixed"),
    "nem": lambda: tns.make_national_tariffs("nem"),
}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small model years: beside the
    suite's other worker processes, more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BANK_FIELDS = ("price", "tier_cap", "sell_price", "hour_period", "fixed_monthly",
               "metering", "n_periods", "n_tiers")


def _banks(name):
    specs = CORPORA[name]()
    return compile_tariffs(specs, device="cpu"), jcompile(specs)


def _bank_equal(t, j):
    for f in BANK_FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# corpus analysis and layout: exactly the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPORA))
def test_analyze_bank_equals_jax(name):
    tb, jb = _banks(name)
    tp, jp = tc.analyze_bank(tb), jtc.analyze_bank(jb)
    assert tp.keys == jp.keys and tp.members == jp.members
    assert tp.n_clusters == jp.n_clusters
    np.testing.assert_array_equal(tp.cluster_of_tariff, jp.cluster_of_tariff)
    np.testing.assert_array_equal(tp.local_of_tariff, jp.local_of_tariff)
    assert tp.cluster_of_tariff.dtype == jp.cluster_of_tariff.dtype
    for t, j in zip(tp.banks, jp.banks, strict=True):
        _bank_equal(t, j)
        assert t.price.device == tb.price.device


def test_analyze_bank_structural_keys():
    plan = tc.analyze_bank(_banks("synth")[0])
    assert plan.n_clusters == 5
    assert set(plan.keys) == {
        (NET_METERING, 1, 1, False), (NET_BILLING, 1, 1, False),
        (NET_METERING, 1, 2, False), (NET_BILLING, 2, 1, False),
        (NET_METERING, 2, 1, False),
    }
    # the mixed national corpus adds the TOU + tiered shape: six signatures
    assert tc.analyze_bank(_banks("mixed")[0]).n_clusters == 6


def test_compact_banks_are_tight_and_faithful():
    bank = _banks("mixed")[0]
    plan = tc.analyze_bank(bank)
    for (m, P, T, _), cb in zip(plan.keys, plan.banks):
        assert cb.price.shape[1:] == (P, T)
        assert int(cb.metering.max()) == m
    for t in range(bank.n_tariffs):
        ci = plan.cluster_of_tariff[t]
        _, P, T, _ = plan.keys[ci]
        lt = plan.local_of_tariff[t]
        assert torch.equal(plan.banks[ci].price[lt], bank.price[t, :P, :T])
        assert torch.equal(plan.banks[ci].fixed_monthly[lt], bank.fixed_monthly[t])


def _random_rows(rng, n, n_tariffs):
    return (rng.integers(0, n_tariffs, n).astype(np.int32),
            (rng.random(n) < 0.8).astype(np.float32))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("pad_mult", [8, 32])
def test_layout_equals_jax(n_dev, pad_mult):
    tb, jb = _banks("mixed")
    tp, jp = tc.analyze_bank(tb), jtc.analyze_bank(jb)
    rng = np.random.default_rng(n_dev * 100 + pad_mult)
    n = 64 * n_dev
    tariff_idx, mask = _random_rows(rng, n, tb.n_tariffs)
    got = tc.plan_layout(tp, tariff_idx, mask, n_dev, pad_mult)
    want = jtc.plan_layout(jp, tariff_idx, mask, n_dev, pad_mult)
    assert tuple(got[0].clusters) == tuple(want[0].clusters)
    assert (got[0].n_dev, got[0].local_len) == (want[0].n_dev, want[0].local_len)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0].cluster_of_rows(), want[0].cluster_of_rows())
    layout, gather, valid, _ = got
    pos = tc.original_positions(gather, valid, n)
    np.testing.assert_array_equal(pos, jtc.original_positions(gather, valid, n))
    real = mask > 0
    np.testing.assert_array_equal(pos >= 0, real)
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(x[gather][pos[real]], x[real])
    for b, wb in zip(tc.banks_for_layout(tp, layout),
                     jtc.banks_for_layout(jp, want[0]), strict=True):
        _bank_equal(b, wb)


def test_layout_flags_and_refusals_equal_jax():
    tb, jb = _banks("synth")
    rows = np.full(128, 3, np.int32), np.ones(128, np.float32)
    lay = tc.plan_layout(tc.analyze_bank(tb), *rows, 4, 32)[0]
    jlay = jtc.plan_layout(jtc.analyze_bank(jb), *rows, 4, 32)[0]
    assert len(lay.clusters) == 1 and lay.local_len == 32
    for f in (lambda l: l.pin_net_billing(False), lambda l: l.with_flags((True,))):
        assert tuple(f(lay).clusters) == tuple(f(jlay).clusters)
    with pytest.raises(ValueError, match="2 flags for 1 clusters"):
        lay.with_flags((True, False))
    with pytest.raises(ValueError, match="not divisible"):
        tc.plan_layout(tc.analyze_bank(tb), np.zeros(10, np.int32),
                       np.ones(10, np.float32), 4, 8)


def test_report_equals_jax_and_cli(capsys):
    spec = dict(n_agents=512, seed=3, tariff_mix="mixed")
    tw = tns.generate_world(tns.NationalSpec(**spec), device="cpu")
    jw = jns.generate_world(jns.NationalSpec(**spec))
    got = tc.cluster_report(tw.tariffs, tw.table.tariff_idx.numpy(), tw.table.mask.numpy())
    assert got == jtc.cluster_report(jw.tariffs, np.asarray(jw.table.tariff_idx),
                                     np.asarray(jw.table.mask))
    assert tc.cluster_report(tw.tariffs) == jtc.cluster_report(jw.tariffs)
    args = ["--report", "--agents", "256", "--seed", "3", "--tariff-mix", "mixed"]
    assert tc.main(args) == 0
    rep = json.loads(capsys.readouterr().out)
    assert jtc.main(args) == 0
    assert rep == json.loads(capsys.readouterr().out)
    assert rep["n_clusters"] >= 5 and rep["n_tariffs"] == 8
    assert 0.0 < rep["modeled_lane_savings"] < 1.0


def test_report_cli_reads_a_package(tmp_path, capsys):
    out = str(tmp_path / "w")
    tns.save_world(tns.NationalSpec(n_agents=300, tariff_mix="mixed"), out)
    assert tc.main(["--report", "--package", out]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["source"] == {"package": out} and rep["n_agents"] == 300
    assert sum(c["n_agents"] for c in rep["clusters"]) == 300


# ---------------------------------------------------------------------------
# the clustered year on the port
# ---------------------------------------------------------------------------

def make_sim(n_agents=N, end_year=2016, quarantine_ids=None, switch=0.0, **rc):
    cfg = ScenarioConfig(name="tc", start_year=2014, end_year=end_year, anchor_years=())
    pop = synth.generate_population(n_agents, states=list(STATES), seed=7,
                                    pad_multiple=32, rate_switch_frac=switch,
                                    device="cpu")
    inputs = scen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                 n_regions=pop.n_regions, device="cpu")
    rc.setdefault("sizing_iters", 4)
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      RunConfig(agent_pad_multiple=PAD, quarantine_ids=quarantine_ids,
                                **rc), device="cpu")


def _keyed(sim, res, field):
    keep = sim.host_mask > 0
    ids = sim.host_agent_id[keep]
    order = np.argsort(ids)
    return ids[order], res.agent[field][:, keep][:, order]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tc-ckpt"))


@pytest.fixture(scope="module")
def parity(ckpt_dir):
    sim_c = make_sim(cluster_tariffs=True)
    sim_u = make_sim()
    return (sim_c, sim_c.run(checkpoint_dir=ckpt_dir), sim_u,
            sim_u.run(checkpoint_dir=ckpt_dir + "-unclustered"))


def test_clustered_matches_unclustered(parity):
    sim_c, res_c, sim_u, res_u = parity
    assert sim_c._cluster_layout is not None and len(sim_c._cluster_layout.clusters) > 1
    assert sim_u._cluster_layout is None
    assert sim_c.cluster_filler_rows == int((sim_c.host_mask == 0).sum()) > 0
    for field in ("system_kw_cum", "number_of_adopters", "npv", "batt_kwh_cum"):
        ids_c, v_c = _keyed(sim_c, res_c, field)
        ids_u, v_u = _keyed(sim_u, res_u, field)
        np.testing.assert_array_equal(ids_c, ids_u)
        np.testing.assert_allclose(v_c, v_u, rtol=1e-5, atol=1e-5, err_msg=field)
    pad = sim_c.host_mask == 0.0
    assert np.all(res_c.agent["new_adopters"][:, pad] == 0.0)
    assert np.all(res_c.agent["system_kw_cum"][:, pad] == 0.0)
    # the kernels ran at each cluster's own width: the compact banks are tight
    for spec, bank in zip(sim_c._cluster_layout.clusters, sim_c._cluster_banks):
        assert bank.price.shape[1:] == (spec.n_periods, spec.n_tiers)
    assert sim_c.step_kwargs(True)["cluster"] is sim_c._cluster_layout
    assert set(sim_c.step_operands()) == {"cluster_banks", "cluster_tidx"}
    assert sim_u.step_operands() == {}


def test_cluster_flags_follow_the_nem_gate(parity):
    sim_c = parity[0]
    flags = [c.net_billing for c in sim_c._cluster_layout.clusters]
    # uniform inputs never close the NEM gate: the NEM clusters run linear
    assert flags == [c.metering == NET_BILLING for c in sim_c._cluster_layout.clusters]
    caps = sim_c.inputs.nem_cap_kw.clone()
    caps[1:] = 0.0
    closing = sim_c._cluster_flags(type(sim_c.inputs)(
        **{**sim_c.inputs.__dict__, "nem_cap_kw": caps}))
    assert all(closing)


def test_clustered_quarantined_rows_stay_inert():
    """Quarantined rows (RunConfig.quarantine_ids) are dropped from the
    cluster layout: no real row carries their ids, and the survivors match
    the unclustered run under the same quarantine."""
    base = make_sim(end_year=2014)
    real = base.host_agent_id[base.host_mask > 0]
    killed = tuple(int(i) for i in real[::7])
    sim_c = make_sim(end_year=2014, quarantine_ids=killed, cluster_tariffs=True)
    sim_u = make_sim(end_year=2014, quarantine_ids=killed)
    assert sim_c.quarantine_report.n_quarantined == len(killed)
    assert not np.isin(sim_c.host_agent_id[sim_c.host_mask > 0], killed).any()
    res_c, res_u = sim_c.run(), sim_u.run()
    ids_c, v_c = _keyed(sim_c, res_c, "system_kw_cum")
    ids_u, v_u = _keyed(sim_u, res_u, "system_kw_cum")
    np.testing.assert_array_equal(ids_c, ids_u)
    assert not np.isin(ids_c, killed).any()
    np.testing.assert_allclose(v_c, v_u, rtol=1e-5, atol=1e-5)


def test_rate_switch_build_stays_unclustered_and_the_call_is_refused(parity):
    sim = make_sim(switch=0.4, cluster_tariffs=True)
    assert sim._rate_switch and sim._cluster_layout is None
    assert sim.step_kwargs(True)["cluster"] is None and sim.step_operands() == {}
    sim_c = parity[0]
    kw = dict(sim_c.step_kwargs(True), rate_switch=True)
    with pytest.raises(ValueError, match="cannot price rate-switch runs"):
        year_step(sim_c.table, sim_c.profiles, sim_c.tariffs, sim_c.inputs,
                  sim_c.init_carry(), 0, **kw, **sim_c.step_operands())


def test_clustered_chunked_equals_clustered_whole_bit_for_bit(parity):
    """The first year of a clustered run in chunks of PAD rows against the
    clustered whole run's."""
    whole, res_w = parity[0], parity[1]
    chunked = make_sim(cluster_tariffs=True, agent_chunk=PAD)
    assert chunked._agent_chunk == PAD and whole._agent_chunk == 0
    assert max(c.seg_len for c in chunked._cluster_layout.clusters) > PAD
    res_k = chunked.run(should_stop=lambda year, yi: True)
    assert res_k.years == [2014]
    for f in ("system_kw_cum", "number_of_adopters", "npv", "payback_period",
              "batt_kwh_cum", "max_market_share"):
        ids_w, v_w = _keyed(whole, res_w, f)
        ids_k, v_k = _keyed(chunked, res_k, f)
        np.testing.assert_array_equal(ids_w, ids_k)
        np.testing.assert_array_equal(v_k[0], v_w[0], err_msg=f)


def test_clustered_resume_is_bit_for_bit(parity, ckpt_dir):
    sim_c, res_c = parity[0], parity[1]
    sim_r = make_sim(cluster_tariffs=True)
    res_r = sim_r.run(checkpoint_dir=ckpt_dir, resume=True, resume_year=2014)
    assert res_r.years == [2016]
    np.testing.assert_array_equal(sim_r.host_agent_id, sim_c.host_agent_id)
    for f, v in res_r.agent.items():
        np.testing.assert_array_equal(v[0], res_c.agent[f][1], err_msg=f)


def test_clustered_resume_under_another_layout_moves_rows_by_agent_id(parity, ckpt_dir):
    from dgen_tpu_torch.io import checkpoint as ckpt
    from dgen_tpu_torch.tree import leaf_paths

    sim_c = parity[0]
    real = sim_c.host_agent_id[sim_c.host_mask > 0]
    killed = tuple(int(i) for i in real[1::5])
    sim_q = make_sim(quarantine_ids=killed, cluster_tariffs=True)
    assert not np.array_equal(sim_q.checkpoint_rows, sim_c.checkpoint_rows)
    restored = sim_q._restore_carry(ckpt_dir, 2014)
    _, old = ckpt.restore_year(ckpt_dir, sim_c.table.n_agents, 2014, device="cpu",
                               rows=sim_c.checkpoint_rows)
    row_of = {int(a): i for i, a in enumerate(sim_c.checkpoint_rows) if a >= 0}
    ids_q = sim_q.checkpoint_rows
    for path, leaf in leaf_paths(restored).items():
        want = leaf_paths(old)[path].numpy()
        got = leaf.numpy()
        for i, a in enumerate(ids_q):
            assert got[i] == (want[row_of[int(a)]] if a >= 0 else 0.0), (path, i)
    assert not np.isin(ids_q, killed).any()


@pytest.mark.parametrize("change", ["quarantine", "halved chunk"])
def test_clustered_resume_across_a_failed_attempt_under_a_new_layout(
        parity, ckpt_dir, tmp_path, change):
    """The supervisor's case: a clustered run checkpoints 2014; an attempt
    under a new layout (a breach's quarantine set, or an OOM retry's
    chunk, which changes the segments' rounding) resumes from it and fails
    in 2016's year step, before its next checkpoint; a third attempt under
    that layout resumes again. Each year keeps its own rows, so the third
    attempt's 2016 equals, bit for bit per agent, that of the uninterrupted
    clustered run (the survivors', under the quarantine)."""
    from dgen_tpu_torch.io import checkpoint as ckpt
    from dgen_tpu_torch.resilience import faults

    sim_c, res_c = parity[0], parity[1]
    real = sim_c.checkpoint_rows[sim_c.checkpoint_rows >= 0]
    # two agents: the segments keep their rounded lengths, so only the
    # rows' order tells the layouts apart
    kw = (dict(quarantine_ids=(int(real[1]), int(real[-2])))
          if change == "quarantine" else dict(agent_chunk=2 * PAD))
    run_dir = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(ckpt_dir, "2014"), os.path.join(run_dir, "2014"))

    def attempt():
        sim = make_sim(cluster_tariffs=True, **kw)
        return sim, sim.run(checkpoint_dir=run_dir, resume=True)

    with faults.injected("year_step@1"), pytest.raises(faults.FaultError):
        attempt()
    assert ckpt.valid_years(run_dir) == [2014]
    sim, res = attempt()
    assert res.years == [2016]
    assert not np.array_equal(sim.checkpoint_rows, sim_c.checkpoint_rows)
    assert (sim.table.n_agents == sim_c.table.n_agents) == (change == "quarantine")
    np.testing.assert_array_equal(
        np.load(os.path.join(run_dir, "2016", ckpt.ROWS_FILE)), sim.checkpoint_rows)
    for f in ("system_kw_cum", "number_of_adopters", "npv", "batt_kwh_cum",
              "batt_adopters_cum", "max_market_share"):
        ids, got = _keyed(sim, res, f)
        ids_c, want = _keyed(sim_c, res_c, f)
        np.testing.assert_array_equal(got[0], want[1][np.isin(ids_c, ids)], err_msg=f)


def test_a_checkpoint_of_the_other_layout_kind_is_refused(parity, ckpt_dir):
    sim_c, sim_u = parity[0], parity[2]
    with pytest.raises(ValueError, match="saved by a clustered run; refusing to "
                                         "restore it into an unclustered one"):
        sim_u._restore_carry(ckpt_dir, 2014)
    with pytest.raises(ValueError, match="saved by an unclustered run; refusing to "
                                         "restore it into a clustered one"):
        sim_c._restore_carry(ckpt_dir + "-unclustered", 2014)
    with pytest.raises(ValueError, match="saved by a clustered run"):
        sim_u.run(checkpoint_dir=ckpt_dir, resume=True)


def test_from_env_reads_the_cluster_switch(monkeypatch):
    for value, on in (("1", True), ("true", True), ("0", False), ("", False)):
        monkeypatch.setenv("DGEN_TPU_CLUSTER", value)
        assert RunConfig.from_env().cluster_tariffs is on
    monkeypatch.setenv("DGEN_TPU_CLUSTER", "1")
    assert RunConfig.from_env(cluster_tariffs=False).cluster_tariffs is False


# ---------------------------------------------------------------------------
# a clustered port run against a clustered JAX run
# ---------------------------------------------------------------------------

def test_clustered_run_matches_jax_clustered():
    """tests/test_torch_slice.py's world (48 agents, storage and the
    state-hourly aggregate on, a NEM cap that closes in year 2, batteries
    attached), clustered in both packages: the same layout, every output
    field per agent within the slice's tolerance, the state-hourly load and
    the national curves within rtol 1e-3, battery adopters equal."""
    from test_torch_slice import N as SN, STATES as SSTATES, _overrides

    kw = dict(states=SSTATES, seed=21, pad_multiple=16)
    jp = jsynth.generate_population(SN, **kw)
    tp = synth.generate_population(SN, device="cpu", **kw)
    g, s = jp.table.n_groups, jp.table.n_states
    cfg_j = jcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
    cfg_t = ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
    jin = jscen.uniform_inputs(cfg_j, n_groups=g, n_regions=jp.n_regions,
                               overrides=_overrides(g, s))
    tin = scen.uniform_inputs(cfg_t, n_groups=g, n_regions=tp.n_regions,
                              overrides=_overrides(g, s), device="cpu")
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs, jin, cfg_j,
                       jcfg.RunConfig(sizing_iters=4, cluster_tariffs=True,
                                      agent_pad_multiple=PAD), with_hourly=True)
    tsim = Simulation(tp.table, tp.profiles, tp.tariffs, tin, cfg_t,
                      RunConfig(sizing_iters=4, cluster_tariffs=True,
                                agent_pad_multiple=PAD), with_hourly=True, device="cpu")
    assert tuple(tsim._cluster_layout.clusters) == tuple(jsim._cluster_layout.clusters)
    # the closing cap leaves every cluster on the bucket-sums path
    assert all(c.net_billing for c in tsim._cluster_layout.clusters)
    np.testing.assert_array_equal(tsim.host_agent_id, np.asarray(jsim.host_agent_id))
    np.testing.assert_array_equal(tsim.host_mask, np.asarray(jsim.host_mask))
    jres, tres = jsim.run(), tsim.run()
    mask = tsim.host_mask
    js, ts = jres.summary(mask), tres.summary(mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    assert js["adopters"][-1] > 0 and js["batt_kwh_cum"][-1] > 0
    np.testing.assert_allclose(tres.state_hourly_net_mw, jres.state_hourly_net_mw,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tres.agent["new_batt_adopters"],
                                  jres.agent["new_batt_adopters"])
    assert set(tres.agent) == set(jres.agent)
    for k, ref in jres.agent.items():
        got = tres.agent[k]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale, err_msg=k)


def test_tier_charges_do_not_depend_on_the_padded_period_count():
    """A tariff's charges are the same bit for bit priced at its own period
    count (its cluster's) and padded to the corpus-wide count, and for a
    row alone or among others: the sums of a clustered and an unclustered
    run then price alike (a reduction over months strided by P moved
    rare national agents' sizes)."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.bill import gather_tariff
    from dgen_tpu_torch.tree import tree_map

    g = torch.Generator().manual_seed(0)
    n, r = 64, 37
    sums1 = (torch.rand((n, r, 12, 1), generator=g) - 0.3) * 2000.0
    tiered = {"price": [[0.10, 0.16]], "tier_cap": [500.0, 1e38], "fixed_charge": 12.0}
    tou = {"price": [[0.1], [0.3]], "e_wkday_12by24": np.ones((12, 24), int)}
    idx = torch.zeros(n, dtype=torch.int32)
    own = gather_tariff(compile_tariffs([tiered], device="cpu"), idx)
    padded = gather_tariff(compile_tariffs([tiered, tou], device="cpu"), idx)
    assert own.price.shape[1] == 1 and padded.price.shape[1] == 2
    sums2 = torch.cat([sums1, torch.zeros_like(sums1)], dim=-1)
    c1 = bk._tier_charge_batched(sums1, own)
    assert torch.equal(bk._tier_charge_batched(sums2, padded), c1)
    few = tree_map(lambda t: t[:5], own)
    assert torch.equal(bk._tier_charge_batched(sums1[:5], few), c1[:5])
