"""``chip_smoke.py`` [3g] (resilience on the card) on the CPU at small
sizes: (a) load-time containment, (b) the fault and quarantine drills
(a subset of the sites, the load-time rounds), (c) the OOM recovery by
chunk halving (with an injected OOM: the CPU has no allocator to
exhaust) and (d) NaN and +Inf loads through the staged bucket sums,
whose CPU path is the plain version on both sides. The phase passes,
and fails on a recovered file that differs by one value and on a
quarantine that misses one row.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_resilience", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small model years: beside
    the suite's other worker processes, more threads only contend (their
    serial seconds fell ~2.4x in a three-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the smallest preset world (no storage: each CPU year skips the plain
#: dispatch loop's 8,760 steps); the card runs national-all-sector and
#: ercot-all-sector
WORLD = "delaware-res"
#: the fewest candidates and a 5-year cash-flow horizon: the CPU's plain
#: bucket sums scale with both
KNOBS = dict(sizing_iters=4)
CONTAINMENT_KW = dict(name=WORLD, n_agents=16, knobs=KNOBS, econ_years=5)
#: one model year and the one site that fires in it (the torn export of
#: the year's first partition); the OOM halving is (c)'s on the CPU
DRILLS_KW = dict(name=WORLD, n_agents=4, chunk=128, end_year=2014,
                 sites=("export_torn",), fast=True, knobs=KNOBS, econ_years=5)
OOM_KW = dict(name=WORLD, n_agents=16, chunk=128, min_chunk=32,
              inject="year_step@1:oom", knobs=KNOBS, econ_years=5)


@pytest.fixture
def small_cap(monkeypatch):
    """A quarantine cap the 16-agent world's bank row 3 is over (6 of its
    agents reference it) and the 4-agent drill world's is not."""
    from dgen_tpu_torch.resilience import quarantine

    monkeypatch.setattr(quarantine, "MAX_QUARANTINE", 4)


def test_resilience_phase_passes_on_the_cpu(tmp_path, small_cap, capsys):
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig

    out = cs.resilience(presets, RunConfig, device="cpu", containment_kw=CONTAINMENT_KW,
                        drills_kw=DRILLS_KW, oom_kw=OOM_KW, workdir=str(tmp_path))
    a, b, c = out["a"], out["b"], out["c"]
    # rows 3 and 17 of the corrupt_rows default, modulo the 16 agents
    assert a["quarantined"] == {3: ["nonfinite:customers_in_bin"],
                                1: ["index:tariff_idx"]}
    assert a["compare"]["compared"] == 3 and a["bank_refs"] > 4
    assert set(b["faults"]["sites"]) == {"export_torn"}
    assert b["faults"]["sites"]["export_torn"]["retries"] == 1
    assert set(b["quarantine"]["rounds"]) == {"ingest", "bank"}
    assert c["chunks"] == [128, 64] and c["bit_for_bit"] in (True, False)
    assert c["per_agent"]["agents"] == 16
    assert c["per_agent"]["first_stage"] in (None, "export codes")
    assert os.listdir(tmp_path) == []
    log = capsys.readouterr().out
    for part in ("[3g] (a)", "refused", "[3g] (b) fault drill", "quarantine drill ingest",
                 "[3g] (c)", "chunks tried [128, 64]", "[3g] resilience phase"):
        assert part in log, part


def test_drills_catch_a_recovered_file_that_differs_by_one_value(tmp_path, monkeypatch):
    """A recovered run whose agent_outputs differ from the clean run's in
    one value (and whose manifest records the changed file, so only the
    comparison can see it) fails [3g] (b). One model year: the site
    fires on the year's first partition."""
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.resilience import drill, faults
    from dgen_tpu_torch.resilience.manifest import RunManifest
    from dgen_tpu_torch.utils.atomic import write_npz

    supervised = drill.run_supervised

    def mutated(make_sim, rc, *, run_dir, **kw):
        out = supervised(make_sim, rc, run_dir=run_dir, **kw)
        if faults.active() is not None:        # a faulted (recovered) run
            rel = os.path.join("agent_outputs", "year=2014.npz")
            with np.load(os.path.join(run_dir, rel)) as z:
                cols = {k: z[k].copy() for k in z.files}
            cols["system_kw_cum"][0] += 1.0
            write_npz(os.path.join(run_dir, rel), cols)
            m = RunManifest(run_dir)
            m.record_artifact(2014, rel)
            m.mark_year_complete(2014)
        return out

    monkeypatch.setattr(drill, "run_supervised", mutated)
    with pytest.raises(AssertionError, match="fault drill failed"):
        cs.drills(RunConfig, device="cpu", workdir=str(tmp_path), **DRILLS_KW)


def test_containment_catches_a_quarantine_that_misses_one_row(tmp_path, small_cap,
                                                              monkeypatch):
    from dgen_tpu_torch import presets
    from dgen_tpu_torch.config import RunConfig
    from dgen_tpu_torch.models import simulation

    validate = simulation.validate_population

    def mutated(*args, **kw):
        # the NaN customer count's row goes unquarantined (the row with an
        # out-of-range tariff could not be built without its quarantine)
        rep = validate(*args, **kw)
        for a, rec in list(rep.records.items()):
            if "nonfinite:customers_in_bin" in rec["reasons"]:
                del rep.records[a]
        return rep

    monkeypatch.setattr(simulation, "validate_population", mutated)
    with pytest.raises(AssertionError, match=r"\[3g\] \(a\) the corrupt build"):
        cs.containment(presets, RunConfig, device="cpu", workdir=str(tmp_path),
                       **CONTAINMENT_KW)


def test_nan_through_kernels_on_the_cpu(capsys):
    """[3g] (d) on first-launch-shaped operands (the CPU's wrappers take
    the plain versions): every output's NaN and Inf positions agree, the
    import sums carry the NaN, and a kernel that drops it is caught."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.tariff import HOURS

    rng = np.random.default_rng(0)
    n, r, p = 8, 6, 2
    offsets = tuple(np.r_[0, np.cumsum([744, 672, 744, 720, 744, 720, 744, 744, 720,
                                        744, 720, 744])].tolist())
    f = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32))
    per = lambda: torch.from_numpy(rng.integers(0, p, (n, HOURS)).astype(np.int32))
    load, gen, sell, scales = f(n, HOURS), f(n, HOURS) * 0.5, f(n, HOURS) * 0.1, f(n, r)
    month = (load, gen, sell, per(), scales, offsets, p)
    captures = {"main": {"month": month + (False,), "month_signed": month + (True,)},
                "gated": {"stream": month + (False,)},
                "switch": {"month_pair": (load, gen, sell, per(), sell * 0.5, per(),
                                          scales, offsets, p)}}
    out = cs.nan_through_kernels(captures, bk, n_agents=n)
    assert set(out) == {"month imports", "month signed", "stream imports", "pair"}
    assert all(v > 0 for v in out.values())
    assert "[3g] (d) pair" in capsys.readouterr().out

    def drops_nan(*args):
        got = bk.month_sums_plain(*args)
        return tuple(torch.nan_to_num(g, nan=0.0) for g in got)

    orig = bk.month_sums
    try:
        bk.month_sums = drops_nan
        with pytest.raises(AssertionError, match="month imports"):
            cs.nan_through_kernels(captures, bk, n_agents=n)
    finally:
        bk.month_sums = orig
