#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (each path runs with the launch counts set to 0 just
before it and read just after; each kernel wrapper keeps the operands of
its first launch in the path):
  1. the card: its name and power limit;
  2. the build of the CUDA kernels from dgen_tpu_torch/csrc (one nvcc per
     source, all started together, sm_90a) and each kernel's registers,
     spills and shared memory;
  3. the main path: ercot-all-sector at 8,192 agents for 3 model years
     (month kernel, battery dispatch kernel), with per-year wall time and
     agent-years/s, and the port on the card against the port on the CPU
     at a small size;
  4. the gated main path: the same world with daylight_compact, pack_once
     and stream_segments (stream kernel, no month kernel), its national
     curves against the main path's;
  5. the rate-switch path (1,024 agents, 2 model years) through the pair
     kernel, then the same with the three knobs (pair kernel on
     daylight-compacted lanes);
  6. the daylight path (1,024 agents, 1 model year, daylight_compact
     alone): the month kernel on compacted lanes, its national curves
     against the same world's without the knob;
  7. the dot path: one model year at 512 agents through
     year_step(..., sizing_impl="dot"), its national curves against the
     month engine's on the same world;
  8. the micro-benchmark path: dgen_tpu_torch.tools.kernel_microbench at
     its own full size (8,192 agents x 250 scales x 8,760 hours, P = 2),
     every default variant: the six variant kernels (sums_variant in its
     seven settings, monthmask, monthmask_g at 4 and 8 agents per block,
     monthdot, monthdot_pre, mnet and mnet_hi) and the month and stream
     kernels through lib, compact, stream and quant (int8 codes); each
     parity line is held to the tolerance of its kind, and an unknown
     variant name must be refused;
  8b. the bf16-banks path: the main path's world with bf16_banks (month
     kernel on bf16 streams), and the int8-banks path: the same world with
     quant_banks, pack_once and stream_segments (stream kernel on int8
     packs); each one's national curves within 2% of the main path's;
  9. each kernel against its plain PyTorch version on the operands the
     paths gave it, with a check that the comparison would catch a
     kernel that drops one TOU period of any agent, and each kernel's
     time beside its plain version's and the card's bound for the same
     work; the battery dispatch kernel, bit for bit against its plain
     loop on the main path's first-year dispatch; logged only: the month
     kernel against the stream kernel on the stream kernel's operands,
     the month kernel at P = 10 on the main path's lanes and scales and
     at 1, 2 and 4 scales a thread, the dispatch kernel on one warp of
     agents (its serial chain), the narrow-stream rows' kernels on
     float32 copies of their operands, the ablated settings of
     sums_variant, its 32-column forms and its device-memory build at
     512 agents; the first year's sizing call broken down (with the
     dispatch kernel and with the plain loop);
 10. a JSON line with every ported kernel, the card, the result line.

Every model path asserts that it launched the battery dispatch kernel
once per model year it ran.

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

MAIN_AGENTS = 8192
MAIN_END_YEAR = 2018          # model years 2014, 2016, 2018
SWITCH_AGENTS = 1024
SWITCH_END_YEAR = 2016        # model years 2014, 2016
DAYLIGHT_AGENTS = 1024
DOT_AGENTS = 512
MICRO_AGENTS = 8192           # the micro-benchmark's own default
HBM_AGENTS = 512              # M from device memory: 2.3 GB at 512 agents
GATED = dict(daylight_compact=True, pack_once=True, stream_segments=True)
#: kernel vs plain version: rtol 1e-4, atol 1e-3 x the agent's largest
#: |plain| value in that output (the two sum float32 terms in different
#: orders; per agent, because loads span 4 MWh/yr homes to GWh/yr plants)
RTOL = 1e-4
ATOL_FRAC = 1e-3
#: the dot kernel multiplies in TF32: the JAX package's bound for its dot
#: engine (rtol 5e-3, atol 2.0) and the per-agent atol at that rtol
DOT_RTOL = 5e-3
DOT_ATOL = 2.0
#: a dropped period must be caught in every agent where it carries at
#: least this share of the agent's largest bucket
DROPPED_SHARE = 1e-2
#: national curves: port on the card vs on the CPU, and the gated path
#: vs the default one (the golden contract)
CURVE_RTOL = 1e-3
#: national curves of the dot engine vs the month engine, and of the bf16
#: and int8 banks vs float32 (tests/test_golden_e2e.py's envelope for a
#: lower-precision engine or bank)
DOT_CURVE_RTOL = 2e-2
BANK_CURVE_RTOL = 2e-2
#: kernel vs plain version on bf16 sums: one bfloat16 unit in the last
#: place (2^-7 of the value) on top of RTOL, as both round the same float32
#: sum, taken in two orders, to bfloat16 and may land on neighbours
BF16_RTOL = RTOL + 2.0 ** -7
BF16 = dict(bf16_banks=True)
QUANT = dict(quant_banks=True, pack_once=True, stream_segments=True)

SOURCES = {
    "month": "dgen_tpu_torch/csrc/bucket_sums.cu",
    "stream": "dgen_tpu_torch/csrc/bucket_sums_stream.cu",
    "dot": "dgen_tpu_torch/csrc/bucket_sums_dot.cu",
    "micro_mask": "dgen_tpu_torch/csrc/microbench_mask.cu",
    "micro_dot": "dgen_tpu_torch/csrc/microbench_dot.cu",
    "micro_pre": "dgen_tpu_torch/csrc/microbench_pre.cu",
    "dispatch": "dgen_tpu_torch/csrc/battery_dispatch.cu",
}
#: float32 operations of one (agent, hour) of the dispatch: two subtracts,
#: two maxes and two mins for surplus and deficit, three each for the
#: charge and discharge limits (subtract, max, divide or multiply) and
#: their mins, a multiply, an add, a divide and a subtract for soc, a
#: subtract and an add for system_out
DISPATCH_OPS = 20
#: the month kernel's logged A/B at the most periods a tariff may carry
AB_PERIODS = 10


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


def micro_pair(fn, plain, n_args=5, **override) -> tuple:
    """(wrapper, plain version) of a micro-benchmark variant over its
    captured operands (``n_args`` tensors, then the keyword arguments),
    with ``override`` laid over the captured keywords; the plain version
    takes the keywords it reads."""
    def call(f, keep=None):
        def run(*a):
            kw = {**a[n_args], **override}
            if keep is not None:
                kw = {k: v for k, v in kw.items() if k in keep}
            return f(*a[:n_args], **kw)
        return run
    return call(fn), call(plain, ("n_periods",) if n_args == 4 else None)


def kernel_specs(bk, mk) -> dict:
    """JSON name -> (capture, wrapper, plain version, float32 operations
    per (agent, scale, lane), rtol, source, TPU kernel replaced). A
    capture is (path, LAUNCHES or NARROW_LAUNCHES key) of the run whose
    first-launch operands the kernel is checked and timed on; the bytes
    of the bound are those of the captured lane arrays and outputs."""
    month = (bk.month_sums, bk.month_sums_plain)
    stream = (bk.stream_sums, bk.month_sums_plain)
    pair = (bk.month_pair_sums, bk.month_pair_sums_plain)
    dot = (bk.dot_sums, bk.dot_sums_plain)
    bp = "dgen_tpu/ops/billpallas.py"
    mb = "tools/kernel_microbench.py"
    return {
        "bucket_sums_month": (("main", "month"), *month, 6, RTOL, "month",
                              f"{bp}:343"),
        "bucket_sums_month_signed": (("main", "month_signed"), *month, 9, RTOL,
                                     "month", f"{bp}:343"),
        "bucket_sums_month_pair": (("switch", "month_pair"), *pair, 9, RTOL,
                                   "month", f"{bp}:427"),
        "bucket_sums_stream": (("gated", "stream"), *stream, 6, RTOL, "stream",
                               f"{bp}:840"),
        "bucket_sums_stream_signed": (("gated", "stream_signed"), *stream, 9,
                                      RTOL, "stream", f"{bp}:840"),
        "bucket_sums_month_compacted": (("daylight", "month"), *month, 6, RTOL,
                                        "month", f"{bp}:343"),
        "bucket_sums_month_signed_daylight": (("daylight", "month_signed"), *month,
                                              9, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_pair_compacted": (("switch_gated", "month_pair"), *pair,
                                             9, RTOL, "month", f"{bp}:427"),
        "bucket_sums_dot": (("dot", "dot"), *dot, 6, DOT_RTOL, "dot",
                            f"{bp}:296"),
        "bucket_sums_dot_signed": (("dot", "dot_signed"), *dot, 9, DOT_RTOL,
                                   "dot", f"{bp}:296"),
        "sums_monthmask": (("micro", "monthmask"),
                           *micro_pair(mk.sums_monthmask, mk.sums_monthmask_plain),
                           6, RTOL, "micro_mask", f"{mb}:112"),
        # the path's first monthmask_g launch has 4 agents per block; the
        # row is the 8-agent launch on the same operands
        "sums_monthmask_g": (("micro", "monthmask_g"),
                             *micro_pair(mk.sums_monthmask_g,
                                         mk.sums_monthmask_g_plain, g_block=8),
                             6, RTOL, "micro_mask", f"{mb}:220"),
        "sums_variant": (("micro", "variant"),
                         *micro_pair(mk.sums_variant, mk.sums_variant_plain),
                         6, DOT_RTOL, "micro_dot", f"{mb}:49"),
        "sums_monthdot": (("micro", "monthdot"),
                          *micro_pair(mk.sums_monthdot, mk.sums_monthdot_plain),
                          6, DOT_RTOL, "micro_dot", f"{mb}:146"),
        # the prebuilt-mask kernels on (load, gen, M, scales)
        "microbench_monthdot_pre": (("micro", "monthdot_pre"),
                                    *micro_pair(mk.monthdot_pre_sums,
                                                mk.mask_product_plain, n_args=4),
                                    6, DOT_RTOL, "micro_pre", f"{mb}:391"),
        "microbench_mnet": (("micro", "mnet"),
                            *micro_pair(mk.mnet_sums, mk.mask_product_plain,
                                        n_args=4),
                            6, DOT_RTOL, "micro_pre", f"{mb}:493"),
        "microbench_mnet_hi": (("micro", "mnet_hi"),
                               *micro_pair(mk.mnet_sums, mk.mask_product_plain,
                                           n_args=4),
                               6, RTOL, "micro_pre", f"{mb}:493"),
        # the engine kernels on narrow streams
        "bucket_sums_month_bf16": (("bf16", "month/bfloat16"), *month, 6, BF16_RTOL,
                                   "month", f"{bp}:343"),
        "bucket_sums_month_int8": (("micro", "month/int8"), *month, 6, RTOL,
                                   "month", f"{bp}:343"),
        "bucket_sums_stream_int8": (("quant", "stream/int8"), *stream, 6, RTOL,
                                    "stream", f"{bp}:840"),
    }


def ab_specs(bk) -> dict:
    """As :func:`kernel_specs`, for the A/Bs logged beside the kernels
    line: the month kernel on the stream kernel's uniform compacted
    operands (the gated path launches no month kernel), and the kernels
    of the narrow-stream rows on float32 copies of the same operands
    (equal operations, four bytes an element; :func:`float32_copies`)."""
    bp = "dgen_tpu/ops/billpallas.py"
    month = (bk.month_sums, bk.month_sums_plain)
    return {
        "bucket_sums_month_on_stream_operands": (
            ("gated", "stream"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_bf16_as_float32": (
            ("bf16", "month/float32"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_month_int8_as_float32": (
            ("micro", "month/int8-float32"), *month, 6, RTOL, "month", f"{bp}:343"),
        "bucket_sums_stream_int8_as_float32": (
            ("quant", "stream/float32"), bk.stream_sums, bk.month_sums_plain, 6,
            RTOL, "stream", f"{bp}:840"),
    }


def float32_copies(captures: dict) -> None:
    """Adds to ``captures`` the narrow-stream rows' operands with load, gen
    and sell as float32 (the same values; int8 codes stay in quantized
    units), for the equal-operation A/Bs of :func:`ab_specs`."""
    def widen(args):
        return tuple(a.float() if i < 3 else a for i, a in enumerate(args))

    captures["bf16"]["month/float32"] = widen(captures["bf16"]["month/bfloat16"])
    captures["micro"]["month/int8-float32"] = widen(captures["micro"]["month/int8"])
    captures["quant"]["stream/float32"] = widen(captures["quant"]["stream/int8"])


def check_variant_forms(operands: tuple, mk, tool) -> None:
    """The ablated settings of sums_variant at the path's full size, and
    its device-memory build at HBM_AGENTS agents, each against its plain
    version (the product forms at the dot kernel's tolerance, the forms
    without a product at the month kernel's) and timed; logged only."""
    import torch

    load, base = operands[0], operands[5]
    if {k: v for k, v in base.items() if v is not None} != dict(
            n_periods=tool.N_PERIODS, b_pad=128, build="onehot", dot="dot",
            net="fma"):
        raise AssertionError(f"the path's first sums_variant launch is not the "
                             f"base setting: {base}")
    forms = [(name, kw, operands[:5]) for name, (kw, real)
             in tool.SUMS_VARIANTS.items() if not real]
    # the one-hot kernel's own width at P = 2 (12 P + 1 columns in 32): how
    # bucket_sums_dot's time splits between forming M and the products
    forms += [(f"b32{tag}", dict(b_pad=32, **kw), operands[:5])
              for tag, kw in (("", {}), ("_const", dict(build="const")),
                              ("_no_dot", dict(dot="none")))]
    part = tuple(t[:HBM_AGENTS] for t in operands[:5])
    g = torch.Generator(device=load.device).manual_seed(1)
    m_hbm = torch.rand((HBM_AGENTS, load.shape[1], 128), generator=g,
                       device=load.device)
    forms.append((f"hbm(M from device memory, {HBM_AGENTS} agents)",
                  dict(build="hbm", m_hbm=m_hbm), part))
    for name, kw, args in forms:
        kw = dict(n_periods=tool.N_PERIODS, **kw)
        got = mk.sums_variant(*args, **kw)
        ref = mk.sums_variant_plain(*args, **kw)
        torch.cuda.synchronize()
        rtol = RTOL if kw.get("dot") == "none" else DOT_RTOL
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        for i, (a, b) in enumerate(zip(got, ref)):
            if bool(bad_agents(a, b, rtol).any()) or (
                    rtol == DOT_RTOL and not torch.allclose(
                        a, b, rtol=DOT_RTOL, atol=DOT_ATOL)):
                raise AssertionError(f"sums_variant {name}: output {i} disagrees "
                                     f"with the plain version (max abs err "
                                     f"{err:.3e})")
        del got, ref
        ms = time_ms(lambda: mk.sums_variant(*args, **kw))
        log(f"  sums_variant {name}: N={args[0].shape[0]} max_abs_err={err:.3e} "
            f"(rtol {rtol}) kernel {ms:.3f} ms")
        torch.cuda.empty_cache()


def micro_path(tool, bk) -> dict:
    """The micro-benchmark at its full size through its entry point, with
    the launch counts set to 0 before and read after; every parity line
    held to its kind's tolerance."""
    bk.CAPTURE = {}
    bk.reset_launches()
    t0 = time.perf_counter()
    try:
        out = tool.run(MICRO_AGENTS)
    finally:
        launches = dict(bk.LAUNCHES)
        capture, bk.CAPTURE = bk.CAPTURE, None
    wall = time.perf_counter() - t0
    narrow = dict(bk.NARROW_LAUNCHES)
    expected = len(tool.SUMS_VARIANTS) + 12
    if len(out["variants"]) != expected or out["timed_on"] != "device":
        raise AssertionError(f"the default run gave {list(out['variants'])} on "
                             f"{out['timed_on']}, expected {expected} variants "
                             "on the device")
    for name, v in out["variants"].items():
        par = v["parity"]
        if not v["ms"] > 0 or (par is not None and par["bad_agents"]):
            raise AssertionError(f"micro-benchmark variant {name}: {v}")
    n_parity = sum(v["parity"] is not None for v in out["variants"].values())
    if n_parity != 13:
        raise AssertionError(f"{n_parity} parity lines, expected 13")
    try:
        tool.run(MICRO_AGENTS, ["monthmasc"])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("the tool ran a variant named 'monthmasc'")
    return dict(out=out, wall=wall, launches=launches, narrow=narrow,
                capture=capture, refusal=refusal)


def bad_agents(got, ref, rtol=RTOL):
    """[N] bool: agents with an element outside rtol + atol ATOL_FRAC x
    that agent's largest |ref| in this output."""
    row_max = ref.abs().flatten(1).amax(1).view(-1, *[1] * (ref.ndim - 1))
    tol = rtol * ref.abs() + ATOL_FRAC * row_max
    return ((got - ref).abs() > tol).flatten(1).any(1)


def dropped_period_caught(ref, rtol=RTOL) -> tuple[int, int, int]:
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
    flagged = bad_agents(mutant, ref, rtol)
    whole = rtol * ref.abs() + ATOL_FRAC * ref.abs().max()
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


def lane_bytes(args, n_lanes: int) -> int:
    """Bytes of the captured lane arrays ([N, L] streams and ids, the
    prebuilt M [N, c, L]) at their own dtypes."""
    import torch

    return sum(t.numel() * t.element_size() for t in args
               if isinstance(t, torch.Tensor) and t.dim() >= 2
               and t.shape[-1] == n_lanes)


def bound_ms(n: int, r: int, work_lanes: int, ops_per_elem: int,
             in_bytes: int, out_bytes: int) -> tuple[float, str]:
    """Least time for the work: operations on the ``work_lanes`` that hold
    an hour (a compacted layout's padding lanes do no work) over the
    float32 peak vs bytes moved (each lane array read once, the float32
    scales read once, each output written once, at their dtypes) over
    HBM."""
    ops = float(n) * r * work_lanes * ops_per_elem
    nbytes = float(in_bytes) + 4.0 * n * r + out_bytes
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_and_time(captures: dict, specs: dict, hour_lanes: dict) -> list:
    """Each kernel of ``specs`` against its plain version, and both timed,
    on the operands a path gave it. ``hour_lanes``: path -> lanes of its
    daylight layout that hold an hour (None without a layout)."""
    import torch

    from dgen_tpu_torch.ops.tariff import HOURS

    rows = []
    for name, (cap, kernel, plain, ops, rtol, src, replaces) in specs.items():
        args = captures[cap[0]][cap[1]]
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.dtype != r.dtype:
                raise AssertionError(f"{name}: the kernel stores {g.dtype}, its "
                                     f"plain version {r.dtype}")
        out_bytes = sum(g.numel() * g.element_size() for g in got)
        got = [g.float() for g in got]
        ref = [r.float() for r in ref]
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        for i, (g, r) in enumerate(zip(got, ref)):
            bad = bad_agents(g, r, rtol)
            if bool(bad.any()):
                raise AssertionError(
                    f"{name}: output {i} disagrees with the plain version for "
                    f"{int(bad.sum())} agents (max abs err {err:.3e})")
            if rtol == DOT_RTOL and not torch.allclose(g, r, rtol=DOT_RTOL,
                                                       atol=DOT_ATOL):
                raise AssertionError(f"{name}: output {i} is outside rtol "
                                     f"{DOT_RTOL} / atol {DOT_ATOL}")
        must, caught, caught_whole = dropped_period_caught(ref[0], rtol)
        if caught != must:
            raise AssertionError(f"{name}: a dropped period passes the check "
                                 f"for {must - caught} of {must} agents")
        n, r = got[1].shape
        n_lanes = args[0].shape[1]
        work_lanes = n_lanes if n_lanes == HOURS else hour_lanes[cap[0]]
        p = got[0].shape[-1] // 12
        del got, ref
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args))
        b_ms, b_by = bound_ms(n, r, work_lanes, ops, lane_bytes(args, n_lanes),
                              out_bytes)
        dtypes = "/".join(str(a.dtype).replace("torch.", "") for a in args[:3])
        log(f"  {name}: N={n} R={r} lanes={n_lanes} ({work_lanes} hours) P={p} "
            f"streams {dtypes} max_abs_err={err:.3e} "
            f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound {b_ms:.3f} ms "
            f"({b_by}); a dropped period is caught in {caught} of {must} agents "
            f"(one atol over the whole output: {caught_whole})")
        rows.append(dict(name=name, source=SOURCES[src], replaces=replaces,
                         path=cap[0], err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, shape=(n, r, n_lanes),
                         work_lanes=work_lanes))
        torch.cuda.empty_cache()
    return rows


def run_path(sim) -> dict:
    """Run every model year of ``sim`` with the launch counts set to 0
    before and read after; returns the results, per-year seconds, wall,
    launch counts and first-launch operands."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    seconds = []
    orig = sim.step

    def step(carry, yi, first_year):
        t0 = time.perf_counter()
        out = orig(carry, yi, first_year)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    sim.step = step
    bk.CAPTURE = {}
    bk.reset_launches()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    try:
        res = sim.run()
    finally:
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
        capture, bk.CAPTURE = bk.CAPTURE, None
    wall = time.perf_counter() - t0
    check_outputs(res, sim.table.n_agents)
    if launches["dispatch"] != len(res.years):
        raise AssertionError(f"{launches['dispatch']} dispatch kernel launches in "
                             f"{len(res.years)} model years")
    lay = sim._daylight
    return dict(res=res, year_s=seconds, wall=wall, launches=launches,
                narrow=dict(bk.NARROW_LAUNCHES),
                capture=capture, n_real=int(sim.host_mask.sum()),
                hour_lanes=None if lay is None else int(lay.valid.sum()))


def report_path(tag: str, title: str, run: dict) -> None:
    res = run["res"]
    n_years = len(res.years)
    log(f"[{tag}] {title}: {run['n_real']} agents x {n_years} years {res.years}; "
        f"per-year s {[round(s, 3) for s in run['year_s']]}, run wall "
        f"{run['wall']:.3f} s, {run['n_real'] * n_years / run['wall']:.1f} "
        f"agent-years/s")
    log(f"    launches {run['launches']}"
        + (f"; on narrow streams {run['narrow']}" if run.get("narrow") else ""))


def need_launches(path: str, launches: dict, keys: tuple, zero: tuple = ()) -> None:
    missing = [k for k in keys if launches[k] == 0]
    extra = [k for k in zero if launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{path}: kernels {missing} never launched or "
                             f"{extra} launched: {launches}")


def curves_gap(a: dict, b: dict, keys=("adopters", "system_kw_cum",
                                       "batt_kwh_cum")) -> float:
    import numpy as np

    return max(float(np.max(np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-6)))
               for k in keys)


def dispatch_operands(sim) -> tuple:
    """(envs, operands) of the first model year's battery dispatch on
    ``sim``'s shapes: the year's sizing inputs, and load, the generation
    of a system sized to the agent's annual load, that system's battery
    and the year's round-trip efficiencies."""
    import torch

    from dgen_tpu_torch.ops import dispatch, sizing

    envs = year0_envs(sim)
    kw = envs.load_kwh_per_customer / torch.clamp_min(envs.gen_per_kw.sum(1), 1e-9)
    batt_kw, batt_kwh = dispatch.batt_size_from_pv(kw)
    gen = envs.gen_per_kw * (sizing.INV_EFF * kw[:, None])
    return envs, (envs.load, gen, batt_kw, batt_kwh, envs.batt_rt_eff)


def breakdown(sim, knobs: dict, kernel_ms: float) -> dict:
    """Seconds of the first year's sizing call (with the run's knobs),
    once with the battery dispatch kernel and once with the plain loop in
    its place, and of the dispatch kernel and the plain loop alone on the
    main path's shapes, each timed alone after a synchronize, beside the
    sum of the isolated launch medians of the year's kernel launches (not
    timed inside the sizing call)."""
    import torch

    from dgen_tpu_torch.ops import dispatch, sizing

    envs, ops = dispatch_operands(sim)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def size():
        sizing.size_agents(
            envs, n_periods=sim.tariffs.max_periods, n_years=sim.econ_years,
            n_iters=sim.run_config.sizing_iters, keep_hourly=sim.with_hourly,
            net_billing=sim._net_billing, **knobs)

    sizing_s = timed(size)
    kernel = dispatch.dispatch_battery
    dispatch.dispatch_battery = lambda *a: dispatch.dispatch_battery_plain(*a)
    try:
        sizing_plain_s = timed(size)
    finally:
        dispatch.dispatch_battery = kernel
    return dict(
        sizing_s=sizing_s, sizing_plain_dispatch_s=sizing_plain_s,
        dispatch_s=timed(lambda: dispatch.dispatch_battery(*ops)),
        dispatch_plain_s=timed(lambda: dispatch.dispatch_battery_plain(*ops)),
        kernel_medians_s=kernel_ms / 1e3,
    )


def dispatch_row(ops: tuple, launches: int) -> dict:
    """The dispatch kernel against its plain loop on ``ops``, bit for
    bit, both timed, its bound (bytes: load and gen read, the four
    outputs written, the three [N] battery inputs read, at 4 bytes; vs
    DISPATCH_OPS float32 operations an (agent, hour)), and the kernel
    on the first warp of agents alone (its serial chain, logged)."""
    import torch

    from dgen_tpu_torch.ops import dispatch

    got = dispatch.dispatch_battery(*ops)
    ref = dispatch.dispatch_battery_plain(*ops)
    torch.cuda.synchronize()
    err = 0.0
    for k in ("system_out", "soc", "charge", "discharge"):
        a, b = getattr(got, k), getattr(ref, k)
        err = max(err, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"battery_dispatch: {k} differs from the plain "
                                 f"loop (max abs err {err:.3e})")
    del got, ref
    n, hours = ops[0].shape
    ms = time_ms(lambda: dispatch.dispatch_battery(*ops))
    plain_ms = time_ms(lambda: dispatch.dispatch_battery_plain(*ops))
    t_bytes = 4.0 * (6 * n * hours + 3 * n) / PEAK_BYTES_PER_S * 1e3
    t_ops = float(n) * hours * DISPATCH_OPS / PEAK_F32_FLOPS * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    warp = tuple(t[:32] for t in ops)
    warp_ms = time_ms(lambda: dispatch.dispatch_battery(*warp))
    log(f"  battery_dispatch: N={n} H={hours} equal to the plain loop bit for bit "
        f"(torch.equal, every output) kernel {ms:.3f} ms | plain {plain_ms:.3f} ms "
        f"| bound {b_ms:.3f} ms ({b_by}); one warp of 32 agents alone (the serial "
        f"chain of {hours} hours) {warp_ms:.3f} ms")
    return dict(name="battery_dispatch", route="cuda", source=SOURCES["dispatch"],
                replaces="dgen_tpu/ops/dispatch.py:88", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape_n_hours=[n, hours],
                serial_chain_ms=warp_ms, path="main")


def month_kernel_ab(imports: tuple, signed: tuple) -> None:
    """Logged A/B of the month kernel on the main path's first imports
    launch (R = 300) at its own P and at AB_PERIODS periods from a seeded
    period map, and on its first signed launch (R = 25), each at 1, 2 and
    4 scales a thread beside the kernel's own choice; at AB_PERIODS also
    against its plain version. Every form sums in the same order, so the
    forms must agree bit for bit."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk

    load, gen, sell, period, scales, offsets, p, _ = imports
    g = torch.Generator(device=load.device).manual_seed(10)
    period10 = torch.randint(0, AB_PERIODS, period.shape, generator=g,
                             device=load.device, dtype=torch.int32)
    cases = [("imports", imports),
             ("imports", (load, gen, sell, period10, scales, offsets, AB_PERIODS,
                          False)),
             ("signed", signed)]
    for kind, a in cases:
        base = bk.month_sums(*a)
        line = [f"own choice {time_ms(lambda: bk.month_sums(*a)):.3f} ms"]
        for spt in bk.MONTH_SCALES_PER_THREAD_FORMS:
            got = bk.month_sums(*a, scales_per_thread=spt)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, base)):
                raise AssertionError(f"month kernel at {spt} scales a thread "
                                     "differs from its own choice")
            del got
            ms = time_ms(lambda: bk.month_sums(*a, scales_per_thread=spt))
            line.append(f"{spt} a thread {ms:.3f} ms")
        msg = ""
        if a[6] == AB_PERIODS:
            ref = bk.month_sums_plain(*a)
            torch.cuda.synchronize()
            for i, (x, y) in enumerate(zip(base, ref)):
                if bool(bad_agents(x, y).any()):
                    raise AssertionError(f"month kernel at P = {AB_PERIODS}: output "
                                         f"{i} disagrees with the plain version")
            err = max(float((x - y).abs().max()) for x, y in zip(base, ref))
            del ref
            msg = (f"; max_abs_err {err:.3e}, plain "
                   f"{time_ms(lambda: bk.month_sums_plain(*a)):.3f} ms")
        del base
        log(f"  month kernel, {kind} at P={a[6]}: N={a[0].shape[0]} "
            f"R={a[4].shape[1]} lanes={a[0].shape[1]}: " + ", ".join(line) + msg)
        torch.cuda.empty_cache()


def check_outputs(res, n_agents: int) -> None:
    import numpy as np

    for k, v in res.agent.items():
        if v.shape[1] != n_agents or not np.all(np.isfinite(v)):
            raise AssertionError(f"output {k} has shape {v.shape} or non-finite values")
    if res.state_hourly_net_mw is not None and not np.all(
            np.isfinite(res.state_hourly_net_mw)):
        raise AssertionError("non-finite state-hourly net load")


def dot_path(presets) -> tuple:
    """One model year at DOT_AGENTS through year_step with the month
    engine and with sizing_impl="dot" from the same carry; returns the
    dot run's launches and first-launch operands, the largest relative
    gap of the national sums, and both runs' national sums."""
    import numpy as np

    from dgen_tpu_torch.models.simulation import year_step
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops import dispatch

    sim, _, _ = presets.build("ercot-all-sector", n_agents=DOT_AGENTS,
                              end_year=2014, device="cuda")
    mask = sim.host_mask

    def national(out) -> dict:
        return {k: np.array([float((getattr(out, f).cpu().numpy() * mask).sum())])
                for k, f in (("adopters", "number_of_adopters"),
                             ("system_kw_cum", "system_kw_cum"),
                             ("batt_kwh_cum", "batt_kwh_cum"))}

    def one_year(impl: str):
        kwargs = dict(sim.step_kwargs(True), sizing_impl=impl)
        return year_step(sim.table, sim.profiles, sim.tariffs, sim.inputs,
                         sim.init_carry(), 0, **kwargs)[1]

    ref = national(one_year("auto"))
    bk.CAPTURE = {}
    bk.reset_launches()
    dispatch.reset_launches()
    try:
        dot = national(one_year("dot"))
    finally:
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
        capture, bk.CAPTURE = bk.CAPTURE, None
    return launches, capture, curves_gap(dot, ref), dot, ref


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
        from dgen_tpu_torch.ops import microkernels as mk
        from dgen_tpu_torch.ops.tariff import HOURS
        from dgen_tpu_torch.tools import kernel_microbench as tool
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
    log(f"[2] built {path} from {len(_build.sources())} sources in {secs:.1f} s")
    for row in _build.kernel_resources(build_log):
        log(f"    {row['kernel']}: {row['registers']} registers, "
            f"{row['spill_bytes']} bytes spilled, {row['smem_bytes']} bytes static "
            "shared memory")
    _build.library()

    def build(n_agents, end_year, knobs=None, **kw):
        return presets.build("ercot-all-sector", n_agents=n_agents,
                             end_year=end_year, device="cuda",
                             run_config=RunConfig(**(knobs or {})), **kw)[0]

    runs = {}
    # --- 3: the main path ---
    sim = build(MAIN_AGENTS, MAIN_END_YEAR)
    if not sim._net_billing or sim._rate_switch:
        raise AssertionError("the preset world does not take the kernel paths")
    torch.cuda.reset_peak_memory_stats()
    runs["main"] = run = run_path(sim)
    report_path("3", "main path ercot-all-sector", run)
    need_launches("main path", run["launches"], ("month", "month_signed", "dispatch"))
    main_curve = run["res"].summary(sim.host_mask)
    if not main_curve["adopters"][-1] > 0:
        raise AssertionError("no national adoption on the main path")
    log(f"    adopters {main_curve['adopters'].tolist()}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the first launches' "
        f"operands held from the first year on), modeled year step "
        f"{sim.modeled_step_bytes / 2**30:.2f} GiB")

    # the port on the card against the port on the CPU (plain versions)
    small = dict(n_agents=64, end_year=2016)
    for knobs in ({}, GATED, BF16, QUANT):
        rc = RunConfig(sizing_iters=4, **knobs)
        gpu_sim, _, _ = presets.build("ercot-all-sector", device="cuda",
                                      run_config=rc, **small)
        cpu_sim, _, _ = presets.build("ercot-all-sector", device="cpu",
                                      run_config=rc, **small)
        g_curve = gpu_sim.run().summary(gpu_sim.host_mask)
        c_curve = cpu_sim.run().summary(cpu_sim.host_mask)
        for k in ("adopters", "system_kw_cum", "batt_kwh_cum"):
            np.testing.assert_allclose(g_curve[k], c_curve[k], rtol=CURVE_RTOL,
                                       err_msg=f"card vs CPU {k} {knobs}")
        log(f"    card vs CPU at 64 agents x 2 years {sorted(knobs) or 'default'}: "
            f"curves agree within rtol {CURVE_RTOL} (adopters "
            f"{g_curve['adopters'].tolist()} vs {c_curve['adopters'].tolist()})")

    # --- 4: the gated main path ---
    gsim = build(MAIN_AGENTS, MAIN_END_YEAR, GATED)
    lay = gsim._daylight
    if lay is None:
        raise AssertionError("the preset's generation bank did not compact")
    log(f"[4] daylight layout: {lay.n_lanes} compacted lanes (months "
        f"{list(lay.seg_lens)}), {lay.uniform().n_lanes} uniform "
        f"({lay.uniform().seg_lens[0]} per month) of {HOURS} hours")
    runs["gated"] = run = run_path(gsim)
    report_path("4", "gated main path (daylight_compact, pack_once, "
                "stream_segments)", run)
    need_launches("gated main path", run["launches"],
                  ("stream", "stream_signed", "dispatch"),
                  zero=("month", "month_signed", "dot", "dot_signed"))
    gap = curves_gap(run["res"].summary(gsim.host_mask), main_curve)
    if gap > CURVE_RTOL:
        raise AssertionError(f"gated curves differ from the main path's by {gap:.3e}")
    log(f"    national curves within {gap:.3e} (relative) of the main path's")
    if run["capture"]["stream"][0].shape[1] != lay.uniform().n_lanes:
        raise AssertionError("the stream kernel did not run the uniform lanes")

    # --- 5: the rate-switch paths ---
    for key, knobs, title in (("switch", None, "rate-switch path"),
                              ("switch_gated", GATED, "gated rate-switch path")):
        rs = build(SWITCH_AGENTS, SWITCH_END_YEAR, knobs, rate_switch_frac=0.4)
        if not rs._rate_switch:
            raise AssertionError("the rate-switch world has no switch")
        runs[key] = run = run_path(rs)
        report_path("5", title, run)
        need_launches(title, run["launches"], ("month_pair", "dispatch"),
                      zero=("month", "stream"))
    if runs["switch_gated"]["capture"]["month_pair"][0].shape[1] == HOURS:
        raise AssertionError("the gated pair kernel ran full-hour lanes")

    # --- 6: daylight_compact alone, and the same world without it ---
    dsim = build(DAYLIGHT_AGENTS, 2014, dict(daylight_compact=True))
    runs["daylight"] = run = run_path(dsim)
    report_path("6", "daylight path (daylight_compact alone)", run)
    need_launches("daylight path", run["launches"],
                  ("month", "month_signed", "dispatch"),
                  zero=("stream", "stream_signed"))
    if run["capture"]["month"][0].shape[1] != dsim._daylight.n_lanes:
        raise AssertionError("the daylight path's month kernel ran full-hour lanes")
    full = run_path(build(DAYLIGHT_AGENTS, 2014))
    full.pop("capture")
    gap = curves_gap(run["res"].summary(dsim.host_mask),
                     full["res"].summary(dsim.host_mask))
    if gap > CURVE_RTOL:
        raise AssertionError(f"daylight curves differ from full-hour by {gap:.3e}")
    log(f"    national curves within {gap:.3e} (relative) of the same world "
        f"without daylight_compact")

    # --- 7: the dot engine ---
    dot_launches, dot_capture, dot_gap, dot_c, ref_c = dot_path(presets)
    runs["dot"] = dict(launches=dot_launches, capture=dot_capture)
    log(f"[7] dot path: {DOT_AGENTS} agents x 1 year through "
        f"year_step(sizing_impl='dot'); launches {dot_launches}; national sums "
        f"within {dot_gap:.3e} (relative) of the month engine's (adopters "
        f"{dot_c['adopters'].tolist()} vs {ref_c['adopters'].tolist()})")
    need_launches("dot path", dot_launches, ("dot", "dot_signed"),
                  zero=("month", "month_signed", "stream"))
    if dot_launches["dispatch"] != 1:
        raise AssertionError(f"dot path: {dot_launches['dispatch']} dispatch kernel "
                             "launches in one model year")
    if dot_gap > DOT_CURVE_RTOL:
        raise AssertionError(f"dot curves differ by {dot_gap:.3e} > {DOT_CURVE_RTOL}")

    # --- 8: the micro-benchmark path ---
    log(f"[8] micro-benchmark path: kernel_microbench.run({MICRO_AGENTS}), every "
        f"default variant (the tool's own lines follow)")
    runs["micro"] = run = micro_path(tool, bk)
    log(f"    {len(run['out']['variants'])} variants in {run['wall']:.3f} s; "
        f"launches {run['launches']}")
    log(f"    every parity line within its kind's tolerance (rtol "
        f"{tool.PARITY_RTOL}, atol {tool.ATOL_FRAC} x the agent's max|lib|); "
        f"an unknown name refused: {run['refusal']}; month launches on int8 "
        f"codes (quant): {run['narrow'].get('month/int8', 0)}")
    need_launches("micro-benchmark path", run["launches"],
                  ("variant", "monthmask", "monthmask_g", "monthdot",
                   "monthdot_pre", "mnet", "mnet_hi", "month", "stream"),
                  zero=("month_signed", "month_pair", "stream_signed", "dot",
                        "dot_signed"))
    if not run["narrow"].get("month/int8"):
        raise AssertionError("the quant variant launched no month kernel on int8")

    # --- 8b: the bf16 and int8 bank paths ---
    for key, knobs, title, kernel, dtype in (
            ("bf16", BF16, "bf16-banks path (bf16_banks)", "month", "bfloat16"),
            ("quant", QUANT, "int8-banks path (quant_banks, pack_once, "
             "stream_segments)", "stream", "int8")):
        bsim = build(MAIN_AGENTS, MAIN_END_YEAR, knobs)
        runs[key] = run = run_path(bsim)
        report_path("8b", title, run)
        need_launches(title, run["launches"], (kernel, kernel + "_signed", "dispatch"),
                      zero=("dot", "dot_signed")
                      + (("month", "month_signed") if kernel == "stream" else
                         ("stream", "stream_signed")))
        narrow = run["narrow"].get(f"{kernel}/{dtype}", 0)
        if narrow != run["launches"][kernel]:
            raise AssertionError(f"{title}: {narrow} of {run['launches'][kernel]} "
                                 f"{kernel} launches on {dtype} streams")
        gap = curves_gap(run["res"].summary(bsim.host_mask), main_curve)
        log(f"    {narrow} {kernel} launches on {dtype} streams; national curves "
            f"within {gap:.3e} (relative) of the float32 main path's (bound "
            f"{BANK_CURVE_RTOL}); modeled year step "
            f"{bsim.modeled_step_bytes / 2**30:.2f} GiB (float32: "
            f"{sim.modeled_step_bytes / 2**30:.2f} GiB)")
        if gap > BANK_CURVE_RTOL:
            raise AssertionError(f"{title}: curves differ from the float32 main "
                                 f"path's by {gap:.3e} > {BANK_CURVE_RTOL}")
        del bsim

    # --- 9: the kernels on the paths' operands ---
    log(f"[9] kernels vs plain versions on the first launch's operands (rtol "
        f"{RTOL}, {DOT_RTOL} for the TF32 tensor-core kernels, {BF16_RTOL:.4e} "
        f"for bf16 sums, atol {ATOL_FRAC} x the agent's max|plain|) "
        f"and times (median of 5 CUDA-event launches after a warm-up):")
    captures = {k: v["capture"] for k, v in runs.items()}
    hour_lanes = {k: v.get("hour_lanes") for k, v in runs.items()}
    rows = check_and_time(captures, kernel_specs(bk, mk), hour_lanes)
    log("  A/Bs, not in the kernels line: the month kernel on the stream kernel's "
        "operands (the gated path launches no month kernel), and the narrow rows' "
        "kernels on float32 copies of their operands (equal operations):")
    float32_copies(captures)
    ab = check_and_time(captures, ab_specs(bk), hour_lanes)[0]
    log(f"  the month kernel on the main path's first launches, at P = {AB_PERIODS} "
        "too (seeded period map), at each count of scales a thread, not in the "
        "kernels line:")
    month_kernel_ab(captures["main"]["month"], captures["main"]["month_signed"])
    log("  settings of sums_variant beside its base row, not in the kernels line:")
    check_variant_forms(captures["micro"]["variant"], mk, tool)
    del captures
    for v in runs.values():
        v.pop("capture", None)
    torch.cuda.empty_cache()
    ms = {r["name"]: r["ms"] for r in rows}
    log(f"    on the stream kernel's operands: month kernel {ab['ms']:.3f} ms, "
        f"stream kernel {ms['bucket_sums_stream']:.3f} ms")
    log("  the battery dispatch kernel on the main path's first-year dispatch "
        "(rebuilt at a system sized to each agent's load):")
    drow = dispatch_row(dispatch_operands(sim)[1], runs["main"]["launches"]["dispatch"])
    ms["battery_dispatch"] = drow["ms"]
    log("  the first year's sizing call, broken down:")
    for tag, s, knobs, names in (
            ("main", sim, {}, ("bucket_sums_month",) * 2 + ("bucket_sums_month_signed",)),
            ("gated", gsim, dict(impl="stream", daylight=lay, pack_once=True),
             ("bucket_sums_stream",) * 2 + ("bucket_sums_stream_signed",))):
        parts = breakdown(s, knobs, sum(ms[n] for n in names + ("battery_dispatch",)))
        log(f"    {tag}: first-year sizing call {parts['sizing_s']:.3f} s with the "
            f"dispatch kernel, {parts['sizing_plain_dispatch_s']:.3f} s with the plain "
            f"loop in its place; alone, the dispatch kernel {parts['dispatch_s']:.4f} s "
            f"and the plain loop {parts['dispatch_plain_s']:.3f} s; the year's four "
            f"kernel launches (three bucket sums, one dispatch), as the sum of their "
            f"isolated medians, {parts['kernel_medians_s']:.4f} s")

    # --- 10: the kernel line, the card, the result ---
    path_launches = {k: {**v["launches"], **v.get("narrow", {})}
                     for k, v in runs.items()}
    specs = kernel_specs(bk, mk)
    kernels = []
    for r in rows:
        path_key, key = specs[r["name"]][0]
        kernels.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=path_launches[path_key][key],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            shape_n_r_lanes=list(r["shape"]), hour_lanes=r["work_lanes"],
            path=path_key,
        ))
    kernels.append(drow)
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of its path never launched: {kernels}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
