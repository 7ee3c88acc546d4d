#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:
  1. the card: its name and power limit;
  2. the build of the CUDA kernels from dgen_tpu_torch/csrc (nvcc, sm_90a);
  3. the main path: ercot-all-sector at 8,192 agents for 3 model years,
     with launch counts, per-year wall time and agent-years/s, and the
     port on the card against the port on the CPU at a small size; each
     kernel wrapper keeps the operands of its first launch;
  4. the rate-switch path (1,024 agents, 2 model years) through the pair
     kernel;
  5. each kernel against its plain PyTorch version on the operands the
     paths gave it, with a check that the comparison would catch a
     kernel that drops one TOU period of any agent;
  6. each kernel's time on those operands beside its plain version's
     and the card's bound for the same work, and the first year's
     sizing call broken down;
  7. a JSON line with every ported kernel, then the result line.

Exits non-zero, printing no result, without a CUDA device, when the
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: published H100 SXM peaks (dense, no sparsity): float32 outside the
#: tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
HOURS = 8760

MAIN_AGENTS = 8192
MAIN_END_YEAR = 2018          # model years 2014, 2016, 2018
SWITCH_AGENTS = 1024
SWITCH_END_YEAR = 2016        # model years 2014, 2016
#: kernel vs plain version: rtol 1e-4, atol 1e-3 x the agent's largest
#: |plain| value in that output (the two sum float32 terms in different
#: orders; per agent, because loads span 4 MWh/yr homes to GWh/yr plants)
RTOL = 1e-4
ATOL_FRAC = 1e-3
#: a dropped period must be caught in every agent where it carries at
#: least this share of the agent's largest bucket
DROPPED_SHARE = 1e-2
#: port on the card vs on the CPU, national curves (the golden contract)
CURVE_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def year0_envs(sim):
    """The sizing inputs the first model year builds."""
    from dgen_tpu_torch.models.scenario import apply_year
    from dgen_tpu_torch.models.simulation import (
        build_econ_inputs, compute_nem_allowed, starting_state_kw)
    from dgen_tpu_torch.ops.sizing import _fill_env_defaults

    ya = apply_year(sim.table, sim.inputs, 0)
    nem = compute_nem_allowed(sim.table, sim.inputs, 0,
                              starting_state_kw(sim.table, sim.inputs))
    return _fill_env_defaults(build_econ_inputs(
        sim.table, sim.profiles, sim.tariffs, ya, nem, sim.table.incentives,
        rate_switch=sim._rate_switch))


def kernel_specs(bk) -> dict:
    """JSON name -> (LAUNCHES key, wrapper, plain version, float32
    operations per (agent, scale, hour), [N, 8760] streams read)."""
    return {
        "bucket_sums_month": ("month", bk.month_sums, bk.month_sums_plain, 6, 4),
        "bucket_sums_month_signed": ("month_signed", bk.month_sums,
                                     bk.month_sums_plain, 9, 4),
        "bucket_sums_month_pair": ("month_pair", bk.month_pair_sums,
                                   bk.month_pair_sums_plain, 9, 6),
    }


def bad_agents(got, ref):
    """[N] bool: agents with an element outside rtol RTOL + atol
    ATOL_FRAC x that agent's largest |ref| in this output."""
    row_max = ref.abs().flatten(1).amax(1).view(-1, *[1] * (ref.ndim - 1))
    tol = RTOL * ref.abs() + ATOL_FRAC * row_max
    return ((got - ref).abs() > tol).flatten(1).any(1)


def dropped_period_caught(ref) -> tuple[int, int, int]:
    """Holds a copy of the bucket sums ``ref`` [N, R, 12P] with the last
    period zeroed (a kernel that drops it) against ``ref``. Returns the
    agents where that period carries >= DROPPED_SHARE of the agent's
    largest bucket, how many of them :func:`bad_agents` flags, and how
    many one atol over the whole output (ATOL_FRAC x max|ref|) would."""
    p = ref.shape[-1] // 12
    mutant = ref.clone()
    mutant[..., p - 1::p] = 0.0
    row_max = ref.abs().flatten(1).amax(1)
    col_max = ref[..., p - 1::p].abs().flatten(1).amax(1)
    must = (col_max >= DROPPED_SHARE * row_max) & (row_max > 0)
    flagged = bad_agents(mutant, ref)
    whole = RTOL * ref.abs() + ATOL_FRAC * ref.abs().max()
    flagged_whole = ((mutant - ref).abs() > whole).flatten(1).any(1)
    return (int(must.sum()), int((flagged & must).sum()),
            int((flagged_whole & must).sum()))


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` launches timed with CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def bound_ms(n: int, r: int, n_periods: int, ops_per_elem: int, n_streams: int,
             n_outs: int) -> tuple[float, str]:
    """Least time for the work: operations over the float32 peak vs bytes
    moved (each stream read once, each output written once) over HBM."""
    ops = float(n) * r * HOURS * ops_per_elem
    nbytes = 4.0 * (n * HOURS * n_streams + n * r
                    + n_outs * n * r * (12 * n_periods + 1))
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_and_time(captured: dict) -> list:
    """Each kernel against its plain version, and both timed, on the
    operands the main path (or the rate-switch path) gave it."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk

    rows = []
    for name, (key, kernel, plain, ops, n_streams) in kernel_specs(bk).items():
        args = captured[key]
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        for i, (g, r) in enumerate(zip(got, ref)):
            bad = bad_agents(g, r)
            if bool(bad.any()):
                raise AssertionError(
                    f"{name}: output {i} disagrees with the plain version for "
                    f"{int(bad.sum())} agents (max abs err {err:.3e})")
        must, caught, caught_whole = dropped_period_caught(ref[0])
        if caught != must:
            raise AssertionError(f"{name}: a dropped period passes the check "
                                 f"for {must - caught} of {must} agents")
        n, r = got[1].shape
        p = got[0].shape[-1] // 12
        n_outs = len(got) // 2
        del got, ref
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        b_ms, b_by = bound_ms(n, r, p, ops, n_streams, n_outs)
        log(f"  {name}: N={n} R={r} P={p} max_abs_err={err:.3e} kernel {ms:.3f} ms"
            f" | plain {plain_ms:.3f} ms | bound {b_ms:.3f} ms ({b_by}); a dropped "
            f"period is caught in {caught} of {must} agents (one atol over the "
            f"whole output: {caught_whole})")
        rows.append(dict(name=name, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, shape=(n, r)))
    return rows


def run_timed(sim):
    """Run every model year; returns (results, per-year seconds)."""
    import torch

    seconds = []
    orig = sim.step

    def step(carry, yi, first_year):
        t0 = time.perf_counter()
        out = orig(carry, yi, first_year)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    sim.step = step
    res = sim.run()
    return res, seconds


def breakdown(sim, rows) -> dict:
    """Seconds of the first year's sizing call and of its battery
    dispatch loop on the main path's shapes, each timed alone after a
    synchronize, beside the sum of the isolated launch medians of the
    year's three kernel launches (not timed inside the sizing call)."""
    import torch

    from dgen_tpu_torch.ops import dispatch, sizing

    envs = year0_envs(sim)
    kw = envs.load_kwh_per_customer / torch.clamp_min(envs.gen_per_kw.sum(1), 1e-9)
    batt_kw, batt_kwh = dispatch.batt_size_from_pv(kw)
    gen = envs.gen_per_kw * (sizing.INV_EFF * kw[:, None])

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ms = {r["name"]: r["ms"] for r in rows}
    return dict(
        sizing_s=timed(lambda: sizing.size_agents(
            envs, n_periods=sim.tariffs.max_periods, n_years=sim.econ_years,
            n_iters=sim.run_config.sizing_iters, keep_hourly=sim.with_hourly,
            net_billing=sim._net_billing)),
        dispatch_s=timed(lambda: dispatch.dispatch_battery(
            envs.load, gen, batt_kw, batt_kwh, envs.batt_rt_eff)),
        kernel_medians_s=(2 * ms["bucket_sums_month"] + ms["bucket_sums_month_signed"]) / 1e3,
    )


def check_outputs(res, n_agents: int) -> None:
    import numpy as np

    for k, v in res.agent.items():
        if v.shape[1] != n_agents or not np.all(np.isfinite(v)):
            raise AssertionError(f"output {k} has shape {v.shape} or non-finite values")
    if res.state_hourly_net_mw is not None and not np.all(
            np.isfinite(res.state_hourly_net_mw)):
        raise AssertionError("non-finite state-hourly net load")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        from dgen_tpu_torch import presets
        from dgen_tpu_torch.config import RunConfig
        from dgen_tpu_torch.ops import _build
        from dgen_tpu_torch.ops import billkernels as bk
    except ImportError as e:
        print(f"the dgen_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1] device: {dev_name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    path, secs, build_log = _build.build()
    log(f"[2] built {path} in {secs:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")
    _build.library()

    sim, _, _ = presets.build("ercot-all-sector", n_agents=MAIN_AGENTS,
                              end_year=MAIN_END_YEAR, device="cuda")
    sim_rs, _, _ = presets.build("ercot-all-sector", n_agents=SWITCH_AGENTS,
                                 end_year=SWITCH_END_YEAR, rate_switch_frac=0.4,
                                 device="cuda")
    if not sim._net_billing or sim._rate_switch or not sim_rs._rate_switch:
        raise AssertionError("the preset worlds do not take the kernel paths")

    # --- 3: the main path ---
    bk.reset_launches()
    bk.CAPTURE = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, year_s = run_timed(sim)
    wall = time.perf_counter() - t0
    main_launches = dict(bk.LAUNCHES)
    captured = {k: bk.CAPTURE[k] for k in ("month", "month_signed") if k in bk.CAPTURE}
    bk.CAPTURE = None
    n_real = int(sim.host_mask.sum())
    check_outputs(res, sim.table.n_agents)
    curve = res.summary(sim.host_mask)
    if not curve["adopters"][-1] > 0:
        raise AssertionError("no national adoption on the main path")
    if main_launches["month"] == 0 or main_launches["month_signed"] == 0:
        raise AssertionError(f"main path skipped the month kernel: {main_launches}")
    log(f"[3] main path ercot-all-sector: {n_real} agents x {len(res.years)} years "
        f"{res.years}")
    for y, s in zip(res.years, year_s):
        log(f"    year {y}: {s:.3f} s")
    log(f"    run wall {wall:.3f} s, {n_real * len(res.years) / wall:.1f} agent-years/s;"
        f" launches {main_launches}; adopters {curve['adopters'].tolist()}")
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(the first launches' operands held from the first year on), modeled "
        f"year step {sim.modeled_step_bytes / 2**30:.2f} GiB")

    # the port on the card against the port on the CPU (plain versions)
    small = dict(n_agents=64, end_year=2016, run_config=RunConfig(sizing_iters=4))
    gpu_sim, _, _ = presets.build("ercot-all-sector", device="cuda", **small)
    cpu_sim, _, _ = presets.build("ercot-all-sector", device="cpu", **small)
    g_curve = gpu_sim.run().summary(gpu_sim.host_mask)
    c_curve = cpu_sim.run().summary(cpu_sim.host_mask)
    for k in ("adopters", "system_kw_cum", "batt_kwh_cum"):
        np.testing.assert_allclose(g_curve[k], c_curve[k], rtol=CURVE_RTOL,
                                   err_msg=f"card vs CPU {k}")
    log(f"    card vs CPU at 64 agents x 2 years: curves agree within rtol "
        f"{CURVE_RTOL} (adopters {g_curve['adopters'].tolist()} vs "
        f"{c_curve['adopters'].tolist()})")

    # --- 4: the rate-switch path ---
    bk.reset_launches()
    bk.CAPTURE = {}
    t0 = time.perf_counter()
    res_rs, year_rs = run_timed(sim_rs)
    wall_rs = time.perf_counter() - t0
    switch_launches = dict(bk.LAUNCHES)
    if "month_pair" in bk.CAPTURE:
        captured["month_pair"] = bk.CAPTURE["month_pair"]
    bk.CAPTURE = None
    check_outputs(res_rs, sim_rs.table.n_agents)
    if switch_launches["month_pair"] == 0:
        raise AssertionError(f"rate-switch path skipped the pair kernel: "
                             f"{switch_launches}")
    n_rs = int(sim_rs.host_mask.sum())
    log(f"[4] rate-switch path: {n_rs} agents x {len(res_rs.years)} years, "
        f"years {[round(s, 3) for s in year_rs]} s, "
        f"{n_rs * len(res_rs.years) / wall_rs:.1f} agent-years/s; "
        f"launches {switch_launches}")

    # --- 5-6: the kernels on the paths' operands ---
    log(f"[5-6] kernels vs plain versions on the first launch's operands (rtol "
        f"{RTOL}, atol {ATOL_FRAC} x the agent's max|plain|) and times (median of "
        f"5 CUDA-event launches after a warm-up):")
    rows = check_and_time(captured)
    del captured
    torch.cuda.empty_cache()
    parts = breakdown(sim, rows)
    log(f"    first-year sizing call {parts['sizing_s']:.3f} s, of which the "
        f"battery dispatch loop {parts['dispatch_s']:.3f} s; the year's three "
        f"kernel launches, as the sum of their isolated medians, "
        f"{parts['kernel_medians_s']:.4f} s")

    # --- 7: the kernel line, the card, the result ---
    launches = {
        "bucket_sums_month": main_launches["month"],
        "bucket_sums_month_signed": main_launches["month_signed"],
        "bucket_sums_month_pair": switch_launches["month_pair"],
    }
    replaces = {
        "bucket_sums_month": "dgen_tpu/ops/billpallas.py:343",
        "bucket_sums_month_signed": "dgen_tpu/ops/billpallas.py:343",
        "bucket_sums_month_pair": "dgen_tpu/ops/billpallas.py:427",
    }
    kernels = [dict(
        name=r["name"], route="cuda", source="dgen_tpu_torch/csrc/bucket_sums.cu",
        replaces=replaces[r["name"]], launches=launches[r["name"]],
        max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        shape_n_r=list(r["shape"]),
    ) for r in rows]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
