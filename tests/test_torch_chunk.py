"""The streaming agent-chunk year step of the PyTorch port.

The port chunked (``agent_chunk=64``, 256 agents, 2 model years, the
state-hourly aggregate and storage on) against the port on the whole
table, at the JAX package's tolerance for this computation
(tests/test_simulation.py::test_chunked_matches_whole_table: per-agent
rtol 2e-5 / atol 1e-4, state-hourly rtol 1e-4 / atol 1e-5), on the
default path, on int8 banks with pack-once and the stream engine (the
hourly remat pass's dequantizing branch) and in a rate-switch world; the
port chunked against the JAX package chunked on the same seeded world
(national curves rtol 1e-3, state-hourly rtol 1e-3 / atol 1e-3 MW,
battery adopters equal per agent, as tests/test_torch_slice.py holds the
whole-table run); the chunk chooser pinned to the port's footprint
model; the chunk count's errors; and the padding of a chunked table.
"""

import math

import numpy as np
import pytest
import torch

from dgen_tpu import config as jcfg
from dgen_tpu.io import synth as jsynth
from dgen_tpu.models import scenario as jscen
from dgen_tpu.models.simulation import Simulation as JSimulation
from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models import simulation as sm
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import dispatch

N = 256
CHUNK = 64
STATES = ["DE", "CA", "TX"]
FIELDS = ("system_kw_cum", "number_of_adopters", "batt_kwh_cum", "npv",
          "payback_period", "max_market_share")
KNOBS = {
    "default": ({}, 0.0),
    "quant": (dict(quant_banks=True, pack_once=True, stream_segments=True), 0.0),
    "rate_switch": ({}, 0.4),
}


def _world(switch: float, device_pkg: str):
    kw = dict(states=STATES, seed=11, pad_multiple=64, rate_switch_frac=switch)
    if device_pkg == "jax":
        pop = jsynth.generate_population(N, **kw)
        cfg = jcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
        ov = {"attachment_rate": np.full(pop.table.n_groups, 0.4, np.float32)}
        inputs = jscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                      n_regions=pop.n_regions, overrides=ov)
    else:
        pop = tsynth.generate_population(N, device="cpu", **kw)
        cfg = tcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
        ov = {"attachment_rate": np.full(pop.table.n_groups, 0.4, np.float32)}
        inputs = tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                      n_regions=pop.n_regions, overrides=ov,
                                      device="cpu")
    return pop, inputs, cfg


def _port_sim(chunk: int, knobs: dict, switch: float) -> sm.Simulation:
    pop, inputs, cfg = _world(switch, "torch")
    return sm.Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                         tcfg.RunConfig(sizing_iters=8, agent_chunk=chunk, **knobs),
                         with_hourly=True, device="cpu")


def _counted_run(sim):
    """The run, and the rows (leading dimension of the first tensor
    argument: an hour stream, or the scales where a pack carries the
    streams) of every battery dispatch and bucket-sums engine call."""
    rows = []
    fns = {(dispatch, "dispatch_battery"): None, (bk, "import_sums"): None,
           (bk, "import_sums_pair"): None, (bk, "bucket_sums"): None}
    for mod, name in fns:
        f = getattr(mod, name)
        fns[(mod, name)] = f

        def wrapped(*a, _f=f, _name=name, **k):
            first = next(x for x in a if isinstance(x, torch.Tensor))
            rows.append((_name, first.shape[0]))
            return _f(*a, **k)

        setattr(mod, name, wrapped)
    try:
        res = sim.run()
    finally:
        for (mod, name), f in fns.items():
            setattr(mod, name, f)
    return res, rows


@pytest.fixture(scope="module", params=sorted(KNOBS))
def port_runs(request):
    knobs, switch = KNOBS[request.param]
    whole = _port_sim(0, knobs, switch)
    chunked = _port_sim(CHUNK, knobs, switch)
    assert whole._agent_chunk == 0 and chunked._agent_chunk == CHUNK
    assert chunked._rate_switch == whole._rate_switch == (switch > 0)
    res_w, rows_w = _counted_run(whole)
    res_c, rows_c = _counted_run(chunked)
    return request.param, whole, res_w, rows_w, chunked, res_c, rows_c


def test_chunked_matches_whole_table(port_runs):
    _, whole, res_w, _, chunked, res_c, _ = port_runs
    m = whole.host_mask
    n = len(m)
    assert chunked.table.n_agents == n == N
    for k in FIELDS:
        np.testing.assert_allclose(res_c.agent[k][:, :n] * m, res_w.agent[k] * m,
                                   rtol=2e-5, atol=1e-4, err_msg=k)
    assert res_c.state_hourly_net_mw.shape == res_w.state_hourly_net_mw.shape
    np.testing.assert_allclose(res_c.state_hourly_net_mw, res_w.state_hourly_net_mw,
                               rtol=1e-4, atol=1e-5)
    assert res_w.summary(m)["adopters"][-1] > 0


def test_chunked_path_forms_no_whole_table_hour_stream(port_runs):
    """Every dispatch and bucket-sums call of the streaming run sees one
    chunk's rows; the dispatch runs twice a chunk a year (sizing and the
    hourly remat pass), once a year on the whole table."""
    name, _, _, rows_w, chunked, res_c, rows_c = port_runs
    years = len(res_c.years)
    k = N // CHUNK
    assert {r for _, r in rows_c} == {CHUNK}, rows_c
    assert {r for _, r in rows_w} == {N}
    n_disp = sum(1 for f, _ in rows_c if f == "dispatch_battery")
    assert n_disp == 2 * k * years
    assert sum(1 for f, _ in rows_w if f == "dispatch_battery") == years
    engine = "import_sums_pair" if name == "rate_switch" else "import_sums"
    per_year_w = sum(1 for f, _ in rows_w if f == engine) / years
    assert per_year_w > 0
    assert sum(1 for f, _ in rows_c if f == engine) == k * per_year_w * years


def test_quant_remat_reads_int8_codes(port_runs):
    name, _, _, _, chunked, _, _ = port_runs
    want = torch.int8 if name == "quant" else torch.float32
    assert chunked.profiles.load.dtype == want


@pytest.fixture(scope="module")
def jax_vs_port():
    pop, inputs, cfg = _world(0.0, "jax")
    jsim = JSimulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                       jcfg.RunConfig(sizing_iters=8, agent_chunk=CHUNK),
                       with_hourly=True)
    assert jsim._agent_chunk == CHUNK
    tsim = _port_sim(CHUNK, {}, 0.0)
    return jsim, jsim.run(), tsim, tsim.run()


def test_chunked_matches_jax_package_chunked(jax_vs_port):
    jsim, jres, tsim, tres = jax_vs_port
    mask = np.asarray(jsim.host_mask)
    np.testing.assert_array_equal(mask, tsim.host_mask)
    js, ts = jres.summary(mask), tres.summary(mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum", "new_adopters"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(tres.state_hourly_net_mw, jres.state_hourly_net_mw,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tres.agent["new_batt_adopters"],
                                  jres.agent["new_batt_adopters"])
    assert tres.agent["new_batt_adopters"].sum() > 0


FOOT = dict(sizing_iters=12, econ_years=25, n_periods=2, rate_switch=False)
CARD = 80 * 2**30


def test_auto_agent_chunk_follows_the_footprint_model():
    kw = dict(FOOT, with_hourly=False)
    assert sm.auto_agent_chunk(8192, memory_bytes=CARD, **kw) == 0
    n = 1 << 20
    c = sm.auto_agent_chunk(n, memory_bytes=CARD, **kw)
    assert c % 128 == 0 and 0 < c < n
    per_agent = sm.per_agent_step_bytes(**kw)
    budget = int(CARD * sm._MEMORY_BUDGET_FRAC) - n * sm._PERSISTENT_ROW_BYTES
    assert c == max(128, budget // per_agent // 128 * 128)
    assert sm.modeled_step_bytes(per_agent, c, n) <= CARD * sm._MEMORY_BUDGET_FRAC
    assert sm.modeled_step_bytes(per_agent, c + 128, n) > CARD * sm._MEMORY_BUDGET_FRAC
    # the hourly profiles and their mix shrink the chunk
    c_h = sm.auto_agent_chunk(n, memory_bytes=CARD, **dict(FOOT, with_hourly=True))
    assert 0 < c_h < c and c_h % 128 == 0
    # narrow banks grow it
    c_q = sm.auto_agent_chunk(n, memory_bytes=CARD, bank_quant=True, **kw)
    assert c_q > c
    # no budget (off a card): never streams by default
    assert sm.auto_agent_chunk(n, memory_bytes=None, **kw) == 0
    # a budget below one 128-row chunk still gives the floor
    assert sm.auto_agent_chunk(n, memory_bytes=2**28, **kw) == 128


def test_n_chunks_and_its_errors():
    assert sm._n_chunks(256, 0) == 1
    assert sm._n_chunks(256, 256) == 1
    assert sm._n_chunks(256, 512) == 1
    assert sm._n_chunks(256, 64) == 4
    with pytest.raises(ValueError, match="not a multiple of agent_chunk"):
        sm._n_chunks(250, 64)
    with pytest.raises(ValueError, match="agent_chunk"):
        tcfg.RunConfig(agent_chunk=-1)
    with pytest.raises(ValueError, match="pad multiple"):
        tcfg.RunConfig(agent_pad_multiple=0)


def _small(n: int, rc: tcfg.RunConfig, pad: int = 8):
    pop = tsynth.generate_population(n, states=STATES, seed=3, pad_multiple=pad,
                                     device="cpu")
    cfg = tcfg.ScenarioConfig(start_year=2014, end_year=2016, anchor_years=())
    inputs = tscen.uniform_inputs(cfg, n_groups=pop.table.n_groups,
                                  n_regions=pop.n_regions, device="cpu")
    return sm.Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg, rc,
                         with_hourly=True, device="cpu")


def test_chunked_table_is_padded_to_the_lcm_with_inert_rows():
    rc = tcfg.RunConfig(agent_chunk=96, agent_pad_multiple=64)
    sim = _small(200, rc)
    rows = math.lcm(64, 96) * 2
    assert sim.table.n_agents == rows == 384
    assert sim._agent_chunk == 96
    assert len(sim.host_mask) == len(sim.host_agent_id) == rows
    assert sim.host_mask[:200].all() and not sim.host_mask[200:].any()
    assert torch.all(sim.table.nem_kw_limit[200:] == 1e30)
    assert torch.all(sim.table.customers_in_bin[200:] == 0)
    assert sim.step_kwargs(False)["agent_chunk"] == 96
    # a chunk no smaller than the table does not stream, and nothing pads
    # on the CPU by default
    assert _small(200, tcfg.RunConfig(agent_chunk=4096))._agent_chunk == 0
    assert _small(200, tcfg.RunConfig())._agent_chunk == 0
    assert _small(200, tcfg.RunConfig()).table.n_agents == 200


def test_memory_error_only_when_the_floor_chunk_cannot_fit(monkeypatch):
    per = sm.per_agent_step_bytes(**dict(FOOT, with_hourly=True))
    n = 1024
    # room for a few hundred rows: the run streams, no error
    monkeypatch.setattr(sm, "card_memory_bytes",
                        lambda dev: int((300 * per + n * 240) / sm._MEMORY_BUDGET_FRAC))
    sim = _small(n, tcfg.RunConfig())
    assert sim._agent_chunk == 256 and sim.table.n_agents == n
    assert sim.modeled_step_bytes == sm.modeled_step_bytes(sim._per_agent_bytes, 256, n)
    # not room for one 128-row chunk
    monkeypatch.setattr(sm, "card_memory_bytes", lambda dev: 100 * per)
    with pytest.raises(MemoryError, match="128-row chunk"):
        _small(n, tcfg.RunConfig())
