"""Per-year checkpoints and resume of the PyTorch port
(dgen_tpu_torch/io/checkpoint.py, ``Simulation.run(checkpoint_dir=,
resume=, resume_year=, should_stop=)``).

* The JAX package's checkpoint contracts (tests/test_io_runtime.py): the
  round trip, a save over a year replacing it, and a resume that matches
  the uninterrupted run (here bit for bit, on one device and one path).
* A torn save is invisible; a checkpoint that does not restore is walked
  past; a carry of the wrong width or leaves is refused; a checkpointed
  year off the year grid is refused.
* Across packages: the JAX package runs 3 years with its orbax
  checkpoints; its 2016 carry (``dgen_tpu.io.checkpoint.restore_year``)
  goes through ``dgen_tpu_torch.convert.sim_carry`` into the port's
  ``save_year``, and the port resumes from it: the remaining year holds
  the JAX package's uninterrupted run at tests/test_torch_slice.py's
  per-agent tolerance (rtol 1e-3, atol 1e-4 x the field's scale, battery
  adopters equal).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dgen_tpu_torch import config as tcfg
from dgen_tpu_torch import convert
from dgen_tpu_torch.io import checkpoint as ckpt
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.models import scenario as tscen
from dgen_tpu_torch.models.market import MarketState
from dgen_tpu_torch.models.simulation import SimCarry, Simulation


def _carry(n: int, offset: float = 0.0) -> SimCarry:
    fields = [f.name for f in dataclasses.fields(MarketState)]
    return SimCarry(
        market=MarketState(**{f: torch.arange(n, dtype=torch.float32) + i + offset
                              for i, f in enumerate(fields)}),
        batt_adopters_cum=torch.full((n,), 7.0 + offset))


def _equal(a: SimCarry, b: SimCarry) -> bool:
    ta, tb = convert.to_numpy_dict(a), convert.to_numpy_dict(b)
    return all(np.array_equal(ta["market"][k], tb["market"][k]) for k in ta["market"]) \
        and np.array_equal(ta["batt_adopters_cum"], tb["batt_adopters_cum"])


def test_checkpoint_roundtrip(tmp_path):
    c = _carry(32)
    ckpt.save_year(str(tmp_path), 2016, c)
    assert ckpt.latest_year(str(tmp_path)) == 2016
    assert ckpt.valid_years(str(tmp_path)) == [2016]
    year, restored = ckpt.restore_year(str(tmp_path), 32, device="cpu")
    assert year == 2016 and _equal(restored, c)
    assert restored.market.system_kw_cum.dtype == torch.float32
    with np.load(tmp_path / "2016" / ckpt.CARRY_FILE) as z:
        assert sorted(z.files) == sorted(
            [f"market.{f.name}" for f in dataclasses.fields(MarketState)]
            + ["batt_adopters_cum"])


def test_checkpoint_overwrite_not_stale(tmp_path):
    """A save over a year replaces it: a resume never restores a previous
    run's carry from the same directory."""
    a, b = _carry(8), _carry(8, offset=5.0)
    with ckpt.Writer(str(tmp_path)) as w:
        w.save(2020, a)
        w.save(2020, b)
    _, restored = ckpt.restore_year(str(tmp_path), 8, device="cpu")
    assert _equal(restored, b)
    assert sorted(os.listdir(tmp_path)) == ["2020"]


def test_torn_and_corrupt_saves(tmp_path):
    """A save that died before its rename (a temp directory, a year
    directory without its file) is not a committed year; a committed
    year that does not restore is walked past; a carry of another width
    is refused."""
    d = str(tmp_path)
    ckpt.save_year(d, 2014, _carry(16))
    ckpt.save_year(d, 2016, _carry(16, offset=1.0))
    os.makedirs(tmp_path / ".tmp-2018-abc")
    (tmp_path / ".tmp-2018-abc" / ckpt.CARRY_FILE).write_bytes(b"torn")
    os.makedirs(tmp_path / "2020")
    assert ckpt.valid_years(d) == [2014, 2016] and ckpt.latest_year(d) == 2016
    (tmp_path / "2016" / ckpt.CARRY_FILE).write_bytes(b"not a zip")
    assert ckpt.latest_valid_year(d, 16, device="cpu") == 2014
    assert ckpt.latest_valid_year(d, 16, max_year=2014, device="cpu") == 2014
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_year(d, 32, 2014, device="cpu")
    assert ckpt.latest_valid_year(d, 32, device="cpu") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_year(d, 16, 2030, device="cpu")


def test_restore_refuses_other_leaves(tmp_path):
    from dgen_tpu_torch.utils.atomic import write_npz

    os.makedirs(tmp_path / "2014")
    write_npz(str(tmp_path / "2014" / ckpt.CARRY_FILE),
              {"batt_adopters_cum": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_year(str(tmp_path), 4, device="cpu")


# ---------------------------------------------------------------------------
# Resume through Simulation.run
# ---------------------------------------------------------------------------

CFG = dict(start_year=2014, end_year=2018, anchor_years=())   # 3 model years


def _sim(async_io=None) -> Simulation:
    cfg = tcfg.ScenarioConfig(**CFG)
    pop = tsynth.generate_population(64, states=["DE", "CA"], seed=7, pad_multiple=32,
                                     device="cpu")
    g = pop.table.n_groups
    inputs = tscen.uniform_inputs(
        cfg, n_groups=g, n_regions=pop.n_regions,
        overrides={"attachment_rate": np.full(g, 0.4, np.float32)}, device="cpu")
    return Simulation(pop.table, pop.profiles, pop.tariffs, inputs, cfg,
                      tcfg.RunConfig(sizing_iters=4, async_host_io=async_io),
                      with_hourly=True, device="cpu")


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt-full")
    sim = _sim()
    return sim.run(checkpoint_dir=str(d / "ck")), d / "ck"


@pytest.mark.parametrize("async_io", [False, True], ids=["serialized", "pipeline"])
def test_resume_matches_uninterrupted(full_run, tmp_path, async_io):
    """A run stopped after year 1 (``should_stop``) and resumed from its
    checkpoints gives the uninterrupted run's remaining years bit for
    bit."""
    full, _ = full_run
    d = str(tmp_path / "ck")
    first = _sim(async_io).run(checkpoint_dir=d, should_stop=lambda y, yi: yi == 0)
    assert first.years == [2014] and ckpt.valid_years(d) == [2014]
    assert first.agent["npv"].shape[0] == 1
    sim = _sim(async_io)
    resumed = sim.run(checkpoint_dir=d, resume=True)
    assert resumed.years == [2016, 2018] and ckpt.valid_years(d) == [2014, 2016, 2018]
    for k, v in resumed.agent.items():
        np.testing.assert_array_equal(v, full.agent[k][1:], err_msg=k)
    np.testing.assert_array_equal(resumed.state_hourly_net_mw, full.state_hourly_net_mw[1:])


def test_resume_year_pins_the_restart_and_off_grid_is_refused(full_run, tmp_path):
    full, d = full_run
    res = _sim().run(checkpoint_dir=str(tmp_path / "copy"), resume=False)
    assert res.years == [2014, 2016, 2018]
    # resume_year picks an earlier committed year than the latest
    import shutil

    shutil.copytree(d, tmp_path / "ck")
    resumed = _sim().run(checkpoint_dir=str(tmp_path / "ck"), resume=True,
                         resume_year=2014, collect=True)
    assert resumed.years == [2016, 2018]
    np.testing.assert_array_equal(resumed.agent["system_kw_cum"],
                                  full.agent["system_kw_cum"][1:])
    # a completed run resumes to nothing left to do
    assert _sim().run(checkpoint_dir=str(d), resume=True).years == []
    ckpt.save_year(str(tmp_path / "off"), 2015, _carry(64))
    with pytest.raises(ValueError, match="year grid"):
        _sim().run(checkpoint_dir=str(tmp_path / "off"), resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _sim().run(resume=True)


# ---------------------------------------------------------------------------
# Across packages: resume the port from the JAX package's checkpoint
# ---------------------------------------------------------------------------

def test_port_resumes_from_a_jax_checkpoint(tmp_path):
    from dgen_tpu import config as jcfg
    from dgen_tpu.io import checkpoint as jckpt
    from dgen_tpu.io import synth as jsynth
    from dgen_tpu.models import scenario as jscen
    from dgen_tpu.models.simulation import Simulation as JSimulation

    jc = jcfg.ScenarioConfig(**CFG)
    jp = jsynth.generate_population(64, states=["DE", "CA"], seed=7, pad_multiple=32)
    g = jp.table.n_groups
    jin = jscen.uniform_inputs(jc, n_groups=g, n_regions=jp.n_regions,
                               overrides={"attachment_rate": np.full(g, 0.4, np.float32)})
    jsim = JSimulation(jp.table, jp.profiles, jp.tariffs, jin, jc,
                       jcfg.RunConfig(sizing_iters=4), with_hourly=True)
    jdir = str(tmp_path / "jax-ck")
    jres = jsim.run(checkpoint_dir=jdir)
    assert jckpt.valid_years(jdir) == [2014, 2016, 2018]

    year, jcarry = jckpt.restore_year(jdir, jp.table.n_agents, 2016)
    carry = convert.sim_carry(convert.to_numpy_dict(jcarry), device="cpu")
    tdir = str(tmp_path / "port-ck")
    ckpt.save_year(tdir, year, carry)
    sim = _sim()
    res = sim.run(checkpoint_dir=tdir, resume=True)
    assert res.years == [2018]
    for k, ref in jres.agent.items():
        ref = ref[2:]
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(res.agent[k], ref, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=k)
    for k in ("new_batt_adopters", "batt_adopters_cum"):
        np.testing.assert_array_equal(res.agent[k], jres.agent[k][2:], err_msg=k)
    assert res.agent["batt_adopters_cum"].sum() > 0
    np.testing.assert_allclose(res.state_hourly_net_mw, jres.state_hourly_net_mw[2:],
                               rtol=1e-3, atol=1e-3)
