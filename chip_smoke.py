#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dgen_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names another checkout of the repository (default
build/parent beside this script, where present), for example the parent
commit unpacked with git archive, whose micro-benchmark tensor-core
kernels [9] times against this checkout's.

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
  7. the dot path: one model year of the main path's world (8,192
     agents) through year_step(..., sizing_impl="dot"), its national
     curves against the month engine's on the same world;
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
     work (the dot kernel's bound: the tensor-core products its bucket
     ids need, forming relu(net), or bytes; sums_variant's bound: the
     TF32 product of the 12 P + 1 columns its outputs need, its CUDA-core
     operations, or bytes, its dense b_pad-column product logged beside
     it; every bucket-sums row's library time: torch.bmm of the
     pre-formed relu(net) and the one-hot M of its buckets, 12 P + 1
     columns a tariff, under TF32, the contraction alone, on the row's
     own operands, the micro path's for the micro-benchmark rows); the
     battery dispatch kernel, bit for bit against its plain
     loop on the main path's first-year dispatch and on every model
     path's first dispatch, its bound the larger of its bytes and its
     serial chain at the SM clock read under load;
     logged only: each row's kernel against its bmm, the dot kernel
     against the month kernel on the dot path's operands, sums_variant
     against the bmm of its 128 columns, sums_monthdot and sums_variant
     against the --parent checkout's kernels (kernel_parent_ab),
     sums_monthdot against the month kernel on the micro path's operands
     at its P and at P = 10, in alternated pairs; the month
     kernel against the stream kernel on the stream kernel's operands,
     the month kernel at P = 10 on the main path's lanes and scales and
     at 1, 2 and 4 scales a thread, the dispatch kernel on one warp of
     agents (its serial chain), the narrow-stream rows' kernels on
     float32 copies of their operands, the ablated settings of
     sums_variant, its 32-column forms and its device-memory build at
     512 agents, each beside its floor; the first year's sizing call broken down (with the
     dispatch kernel and with the plain loop); the stream kernel against
     the month kernel on the gated and int8-banks paths' operands, and the
     pair kernel against two month launches on both rate-switch paths'
     operands, bit for bit (a mismatch fails the run) and timed;
 9c. one carry year of the main path and of the gated path under
     torch.profiler: the ten longest device operations with their
     launch counts, kernel time against the year's wall time, the
     device's idle share, and each piece of the year's host and device
     time;
 10. a JSON line with every ported kernel, the card, the result line.

Every model path asserts that it launched the battery dispatch kernel
once per model year it ran.

Exits non-zero, printing no result, without a CUDA device, when the
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

#: published H100 SXM peaks (dense, no sparsity): float32 outside the
#: tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: dense TF32 on the tensor cores
PEAK_TF32_FLOPS = 495e12

MAIN_AGENTS = 8192
MAIN_END_YEAR = 2018          # model years 2014, 2016, 2018
SWITCH_AGENTS = 1024
SWITCH_END_YEAR = 2016        # model years 2014, 2016
DAYLIGHT_AGENTS = 1024
DOT_AGENTS = MAIN_AGENTS
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
#: dependent instructions between two hours' soc in the dispatch kernel's
#: fast path, counted in its SASS (cuobjdump -sass): subtract, max, three
#: multiply-adds (the division), min, multiply, add, subtract; each takes
#: DEPENDENT_CYCLES, the arithmetic latency the CUDA C++ Programming Guide
#: gives for compute capability 7.0 and later
DISPATCH_CHAIN = 9
DEPENDENT_CYCLES = 4
#: the dot kernel's column tiles: 7 buckets and a sell slot of 8 columns
#: (csrc/bucket_sums_dot.cu kGroup), and hours of a k-step
DOT_GROUP = 7
DOT_K = 8
#: f32 operations per (scale, hour) to form relu(net) (a multiply-add and
#: a max; the signed kernel takes net from the same multiply-add)
DOT_FORM_OPS = 3
#: bytes of pre-formed operands a torch.bmm yardstick call may take
BMM_BYTES = 12 << 30
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
        n, r = args[4].shape
        hours = args[0].shape[1]
        if kw.get("dot") == "none":
            floor = (f"CUDA-core floor "
                     f"{float(n) * r * hours * 6 / PEAK_F32_FLOPS * 1e3:.3f} ms")
        else:
            p, cols = kw["n_periods"], kw.get("b_pad", 128)
            need, dense = variant_floors_ms(n, r, hours, p, cols)
            floor = (f"TF32 floor of the {12 * p + 1} columns the outputs need "
                     f"{need:.3f} ms, dense TF32 floor of all {cols} columns "
                     f"{dense:.3f} ms")
        log(f"  sums_variant {name}: N={n} max_abs_err={err:.3e} "
            f"(rtol {rtol}) kernel {ms:.3f} ms; {floor}")
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


def dot_bound_ms(args, out_bytes: int) -> tuple[float, str, str]:
    """Least time for the dot kernel's work on ``args``: the larger of the
    TF32 products of the column tiles these bucket ids touch (per k-step
    of DOT_K hours, the distinct tiles of DOT_GROUP buckets, each R rows x
    8 columns x DOT_K hours; twice that signed) over the tensor cores'
    peak, forming relu(net) (DOT_FORM_OPS float32 operations per (scale,
    hour)) over the CUDA cores' peak, and the bytes (each stream and the
    scales read once, each output written once). Returns (ms, "operations"
    or "bytes", a note naming what sets it beside the dense product's
    floor, all 12 P + 1 columns padded to a multiple of 8)."""
    import torch

    load, gen, sell, bucket, scales, p, signed = args
    n, r = scales.shape
    hours = bucket.shape[1]
    tiles = (bucket // DOT_GROUP).view(n, hours // DOT_K, DOT_K).long()
    live = torch.zeros((n, hours // DOT_K, -(-12 * p // DOT_GROUP)),
                       dtype=torch.bool, device=bucket.device)
    live.scatter_(2, tiles, True)
    products = float(live.sum())
    del live, tiles
    a_sets = 2 if signed else 1
    t_tc = products * r * 8 * DOT_K * 2 * a_sets / PEAK_TF32_FLOPS * 1e3
    t_form = float(n) * r * hours * DOT_FORM_OPS / PEAK_F32_FLOPS * 1e3
    t_bytes = (lane_bytes(args, hours) + 4.0 * n * r + out_bytes) / PEAK_BYTES_PER_S * 1e3
    dense = (float(n) * r * hours * -(-(12 * p + 1) // 8) * 8 * 2 * a_sets
             / PEAK_TF32_FLOPS * 1e3)
    b_ms, what = max((t_tc, "tensor-core products"), (t_form, "forming relu(net)"),
                     (t_bytes, "bytes"))
    note = (f"bound set by {what} (tensor-core products {t_tc:.3f} ms over "
            f"{products / (n * hours / DOT_K):.3f} live tiles a k-step, forming "
            f"relu(net) {t_form:.3f} ms, bytes {t_bytes:.3f} ms; the dense "
            f"product's tensor-core floor {dense:.3f} ms)")
    return b_ms, "bytes" if what == "bytes" else "operations", note


def lane_buckets(period, offsets, p: int):
    """[N, L] bucket ids month x P + period of lanes whose month m is
    [offsets[m], offsets[m + 1]), and the lanes whose period lies in [0,
    P) (the others count for the sell sum alone)."""
    import torch

    lens = torch.tensor([b - a for a, b in zip(offsets[:-1], offsets[1:])],
                        device=period.device)
    month = torch.repeat_interleave(torch.arange(12, device=period.device), lens)
    period = period.long()
    return month * p + period, (period >= 0) & (period < p)


def sums_terms(args) -> tuple:
    """A bucket-sums row's operands as (load, gen, scales, P, signed,
    tariffs), ``tariffs`` one (bucket ids, valid lanes, sell) [N, L] each:
    ``args`` are the dot kernel's (load, gen, sell, bucket ids, scales, P,
    signed), the month and stream kernels' (load, gen, sell, period,
    scales, offsets, P, signed) or the pair kernel's (load, gen, sell_a,
    period_a, sell_b, period_b, scales, offsets, P)."""
    if len(args) == 7:
        load, gen, sell, bucket, scales, p, signed = args
        return load, gen, scales, p, signed, [(bucket.long(), None, sell)]
    if len(args) == 8:
        load, gen, sell, period, scales, offsets, p, signed = args
        return load, gen, scales, p, signed, [(*lane_buckets(period, offsets, p), sell)]
    load, gen, sell_a, period_a, sell_b, period_b, scales, offsets, p = args
    return load, gen, scales, p, False, [
        (*lane_buckets(period, offsets, p), sell)
        for period, sell in ((period_a, sell_a), (period_b, sell_b))]


def bmm_operands(terms: tuple, a0: int, a1: int, cols: int) -> tuple:
    """The bmm yardstick's operands for agents [a0, a1) of ``terms``
    (:func:`sums_terms`): relu(net) (and net below it, signed) [n, R or
    2R, L] and M [n, L, cols x tariffs], per tariff its one-hot bucket
    columns, zero columns up to its last, and the sell rate in its
    last."""
    import torch

    load, gen, scales, p, signed, tariffs = terms
    nb = 12 * p
    ld, gn, sc = (t[a0:a1].float() for t in (load, gen, scales))
    net = ld[:, None, :] - sc[:, :, None] * gn[:, None, :]
    a = torch.clamp_min(net, 0.0)
    if signed:
        a = torch.cat([a, net], dim=1)
    del net
    m = torch.zeros((a1 - a0, load.shape[1], cols * len(tariffs)), device=load.device)
    for t, (bucket, valid, sell) in enumerate(tariffs):
        mt = m[:, :, t * cols:(t + 1) * cols]
        ids = bucket[a0:a1].clamp(0, nb - 1)[..., None]
        if valid is None:
            mt.scatter_(2, ids, 1.0)
        else:  # an hour outside [0, P) has no import column
            mt.scatter_(2, ids, valid[a0:a1, :, None].float())
        mt[:, :, cols - 1] = sell[a0:a1].float()
    return a, m


def bmm_outputs(out, terms: tuple, cols: int) -> tuple:
    """The bucket sums in the bmm's product ``out`` [n, R or 2R, cols x
    tariffs], in the order the row's kernel returns them."""
    r, p, signed, tariffs = terms[2].shape[1], terms[3], terms[4], terms[5]
    nb = 12 * p
    want = ()
    for t in range(len(tariffs)):
        c0 = t * cols
        want += (out[:, :r, c0:c0 + nb], out[:, :r, c0 + cols - 1])
    if signed:
        want += (out[:, r:, :nb], out[:, r:, cols - 1])
    return want


def bmm_yardstick(args, kernel, what: str, cols=None, rtol=DOT_RTOL) -> float:
    """A bucket-sums row's library time: one torch.bmm of the pre-formed
    relu(net) (and net, signed) [n, R, L] with M [n, L, cols x tariffs]
    (:func:`bmm_operands`; ``cols`` defaults to 12 P + 1, all the function
    needs) under TF32 (set and restored around these timings only), the
    contraction alone: the medians of agent chunks of at most BMM_BYTES
    of operands, each formed before it is timed, added up. On the first
    chunk the bmm is held to ``kernel`` (called on ``args`` cut to the
    chunk's agents) at the larger of ``rtol`` and the dot tolerance, and
    the two are timed in alternated pairs (logged)."""
    import torch

    from dgen_tpu_torch.tools.kernel_microbench import ab_ms
    from dgen_tpu_torch.tools.kernel_parent_ab import first_rows

    terms = sums_terms(args)
    load, scales, p, signed, tariffs = terms[0], terms[2], terms[3], terms[4], terms[5]
    n, r = scales.shape
    hours = load.shape[1]
    cols = cols or 12 * p + 1
    width = cols * len(tariffs)
    a_rows = r * (2 if signed else 1)
    chunk = max(1, min(n, BMM_BYTES // (4 * hours * (a_rows + width))))

    total, calls = 0.0, 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for a0 in range(0, n, chunk):
            a1 = min(n, a0 + chunk)
            a, m = bmm_operands(terms, a0, a1, cols)
            if a0 == 0:
                part = first_rows(args, a1)
                got = kernel(*part)
                want = bmm_outputs(torch.bmm(a, m), terms, cols)
                for g, w in zip(got, want, strict=True):
                    if bool(bad_agents(g.float(), w, max(rtol, DOT_RTOL)).any()):
                        raise AssertionError(f"the torch.bmm yardstick disagrees with "
                                             f"{what}")
                del got, want
                ms, bmm_ms, wins = ab_ms(lambda: kernel(*part),
                                         lambda: torch.bmm(a, m))
                log(f"    {what} vs torch.bmm of pre-formed relu(net) and M [{width} "
                    f"columns] (TF32, the contraction alone) on agents 0-{a1 - 1}: "
                    f"kernel {ms:.3f} ms | bmm {bmm_ms:.3f} ms (medians of 6 "
                    f"alternated pairs; kernel faster in {wins})")
            total += time_ms(lambda: torch.bmm(a, m))
            calls += 1
            del a, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"    torch.bmm yardstick [{width} columns] over all {n} agents: {calls} "
        f"calls of up to {chunk} agents, {total:.3f} ms in all (operands formed "
        "outside the timing)")
    return total


def micro_library_ms(operands: tuple, mk) -> float:
    """The micro-benchmark rows' library time on the micro path's operands
    (the first sums_variant launch's: load, gen, sell, bucket ids, scales,
    keywords): the bmm yardstick at 12 P + 1 columns, the function every
    micro-benchmark kernel computes, held to and timed against
    sums_monthdot. The yardstick at the variant's own b_pad columns, the
    product its ablation multiplies, is held to and timed against
    sums_variant and logged only."""
    kw = operands[5]
    p, b_pad = kw["n_periods"], kw["b_pad"]
    args = tuple(operands[:5]) + (p, False)
    log("  library time of the micro-benchmark rows (the torch.bmm yardstick on "
        "the micro path's operands):")
    library = bmm_yardstick(args, lambda *a: mk.sums_monthdot(*a[:5], n_periods=p),
                            "sums_monthdot")
    dense = bmm_yardstick(args, lambda *a: mk.sums_variant(*a[:5], n_periods=p,
                                                           b_pad=b_pad),
                          "sums_variant", cols=b_pad)
    log(f"    the micro rows' library time is the {12 * p + 1}-column bmm, "
        f"{library:.3f} ms; the {b_pad}-column bmm ({dense:.3f} ms) computes the "
        "same outputs with zero columns and is not a row's")
    return library


def variant_floors_ms(n: int, r: int, hours: int, p: int, b_pad: int) -> tuple:
    """sums_variant's tensor-core floors: the TF32 product of the 12 P + 1
    columns its outputs need, and the dense product of all ``b_pad``
    columns its ablation multiplies (2 N R H columns operations each, at
    the TF32 peak)."""
    per_col = 2.0 * n * r * hours / PEAK_TF32_FLOPS * 1e3
    return per_col * (12 * p + 1), per_col * b_pad


def variant_bound_ms(n: int, r: int, hours: int, p: int, b_pad: int,
                     in_bytes: int, out_bytes: int) -> tuple[float, str, str]:
    """Least time for sums_variant's function: the larger of its CUDA-core
    operations (6 a (agent, scale, hour)), the TF32 product of the 12 P +
    1 columns its outputs need, and the bytes. The dense product of its
    ``b_pad`` columns, which includes columns known to be zero, is named
    in the note and not counted. Returns (ms, "operations" or "bytes", the
    note)."""
    t_ops = float(n) * r * hours * 6 / PEAK_F32_FLOPS * 1e3
    t_tc, t_dense = variant_floors_ms(n, r, hours, p, b_pad)
    t_bytes = (float(in_bytes) + 4.0 * n * r + out_bytes) / PEAK_BYTES_PER_S * 1e3
    b_ms = max(t_ops, t_tc, t_bytes)
    note = (f"; bound: the TF32 product of the {12 * p + 1} columns the outputs "
            f"need {t_tc:.3f} ms, CUDA-core operations {t_ops:.3f} ms, bytes "
            f"{t_bytes:.3f} ms; the dense TF32 product of all {b_pad} columns "
            f"{t_dense:.3f} ms (not the bound)")
    return b_ms, "bytes" if b_ms == t_bytes else "operations", note


def monthdot_month_ab(operands: tuple, mk) -> None:
    """sums_monthdot against the month kernel on the micro path's operands
    (the same function: bucket ids as period ids on the full-hour lanes),
    at the path's P and at AB_PERIODS periods from a seeded period map
    (monthdot's two-tile form), held to the dot tolerance and timed in
    alternated pairs; logged."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.layout import FULL_OFFSETS
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    load, gen, sell, bucket, scales = operands[:5]
    g = torch.Generator(device=load.device).manual_seed(10)
    period10 = torch.randint(0, AB_PERIODS, bucket.shape, generator=g,
                             device=load.device, dtype=torch.int32)
    for p, ids in ((operands[5]["n_periods"], bucket),
                   (AB_PERIODS, bk.hourly_bucket_ids(period10, AB_PERIODS))):
        args = (load, gen, sell, ids, scales)
        month = (load, gen, sell, (ids % p).to(torch.int32), scales, FULL_OFFSETS,
                 p, False)
        got = mk.sums_monthdot(*args, n_periods=p)
        ref = bk.month_sums(*month)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if bool(bad_agents(a, b, DOT_RTOL).any()) or not torch.allclose(
                    a, b, rtol=DOT_RTOL, atol=DOT_ATOL):
                raise AssertionError(f"sums_monthdot disagrees with the month kernel "
                                     f"on the same operands at P = {p}")
        del got, ref
        ms, month_ms, wins = ab_ms(lambda: mk.sums_monthdot(*args, n_periods=p),
                                   lambda: bk.month_sums(*month))
        log(f"  sums_monthdot vs the month kernel on the micro path's operands: "
            f"N={load.shape[0]} R={scales.shape[1]} P={p}: within rtol {DOT_RTOL} / "
            f"atol {DOT_ATOL}; monthdot {ms:.3f} ms | month kernel {month_ms:.3f} ms "
            f"(medians of 6 alternated pairs; monthdot faster in {wins})")


def parent_ab(operands: tuple, parent_root: str) -> None:
    """The redesigned micro-benchmark kernels (sums_variant, sums_monthdot)
    against another checkout's (``parent_root``, e.g. the parent commit
    unpacked with git archive) on the micro path's operands, through
    kernel_parent_ab: both held to the plain version at the dot tolerance
    (rtol and the per-agent atol), then timed in 6 alternated pairs;
    logged. Skipped, and said so, without such a checkout."""
    import os

    from dgen_tpu_torch.ops import _build
    from dgen_tpu_torch.tools import kernel_parent_ab as ab

    csrc = os.path.join(parent_root, "dgen_tpu_torch", "csrc")
    if not os.path.isdir(csrc):
        log(f"  the redesigned kernels against the parent's: skipped, no checkout "
            f"at {parent_root} (unpack the parent commit there with git archive)")
        return
    t0 = time.perf_counter()
    other = _build.library(csrc)
    log(f"  the redesigned kernels against the checkout at {parent_root} (its "
        f"kernels built in {time.perf_counter() - t0:.1f} s), on the micro path's "
        "operands:")
    args = tuple(operands[:5])
    for key in ("variant", "monthdot"):
        row = ab.compare(key, args, other, DOT_RTOL, DOT_ATOL)
        if row["this_bad_agents"] or row["this_tol_ratio"] > 1.0:
            raise AssertionError(f"{key}: this checkout's kernel is outside the dot "
                                 f"tolerance: {row}")
        row.update(ab.timed(key, args, other))
        log(f"    {key}: this checkout {row['ms']:.3f} ms | parent "
            f"{row['other_ms']:.3f} ms (this faster in {row['wins']} of 6 "
            f"alternated pairs); against the plain version max abs err "
            f"{row['this_max_abs_err']:.3e} (parent {row['other_max_abs_err']:.3e}), "
            f"agents outside rtol {DOT_RTOL} + the per-agent atol "
            f"{row['this_bad_agents']} (parent {row['other_bad_agents']})")


def dot_month_ab(captures: dict) -> None:
    """The dot kernel against the month kernel on the dot path's own
    operands (bucket ids as period ids on the full-hour lanes), held to the
    dot tolerance and timed in alternated pairs; logged."""
    import torch

    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.ops.layout import FULL_OFFSETS
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    for key in ("dot", "dot_signed"):
        load, gen, sell, bucket, scales, p, signed = args = captures["dot"][key]
        month = (load, gen, sell, (bucket % p).to(torch.int32), scales, FULL_OFFSETS,
                 p, signed)
        got, ref = bk.dot_sums(*args), bk.month_sums(*month)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            if bool(bad_agents(g, r, DOT_RTOL).any()) or not torch.allclose(
                    g, r, rtol=DOT_RTOL, atol=DOT_ATOL):
                raise AssertionError(f"{key}: the dot kernel disagrees with the "
                                     "month kernel on the same operands")
        del got, ref
        ms, month_ms, wins = ab_ms(lambda: bk.dot_sums(*args),
                                   lambda: bk.month_sums(*month))
        log(f"  {key} vs the month kernel on the dot path's operands: N={load.shape[0]} "
            f"R={scales.shape[1]} P={p}: within rtol {DOT_RTOL} / atol {DOT_ATOL}; "
            f"dot kernel {ms:.3f} ms | month kernel {month_ms:.3f} ms (medians of 6 "
            f"alternated pairs; dot faster in {wins})")


def check_and_time(captures: dict, specs: dict, hour_lanes: dict,
                   micro_library: float | None = None) -> list:
    """Each kernel of ``specs`` against its plain version, and both timed,
    on the operands a path gave it. ``hour_lanes``: path -> lanes of its
    daylight layout that hold an hour (None without a layout);
    ``micro_library``: the micro-benchmark rows' library ms
    (:func:`micro_library_ms`). With it, every other row's library time
    is the bmm yardstick on its own operands; without it (the logged
    A/Bs), no row has one."""
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
        library_ms, note = None, ""
        if src == "dot":
            b_ms, b_by, note = dot_bound_ms(args, out_bytes)
            note = "; " + note
        elif name == "sums_variant":
            b_ms, b_by, note = variant_bound_ms(
                n, r, n_lanes, p, args[5]["b_pad"], lane_bytes(args, n_lanes),
                out_bytes)
        else:
            b_ms, b_by = bound_ms(n, r, work_lanes, ops, lane_bytes(args, n_lanes),
                                  out_bytes)
        if src.startswith("micro"):
            library_ms = micro_library
        elif micro_library is not None:
            library_ms = bmm_yardstick(args, kernel, name, rtol=rtol)
        if library_ms is not None:
            note += f"; library (torch.bmm, TF32) {library_ms:.3f} ms"
        dtypes = "/".join(str(a.dtype).replace("torch.", "") for a in args[:3])
        log(f"  {name}: N={n} R={r} lanes={n_lanes} ({work_lanes} hours) P={p} "
            f"streams {dtypes} max_abs_err={err:.3e} "
            f"kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound {b_ms:.3f} ms "
            f"({b_by}){note}; a dropped period is caught in {caught} of {must} "
            f"agents (one atol over the whole output: {caught_whole})")
        rows.append(dict(name=name, source=SOURCES[src], replaces=replaces,
                         path=cap[0], err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                         shape=(n, r, n_lanes), work_lanes=work_lanes))
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def first_dispatch(capture: dict):
    """Keeps the operands of the first battery dispatch made inside the
    block in ``capture["dispatch"]``; the dispatch runs as it would."""
    from dgen_tpu_torch.ops import dispatch

    kernel = dispatch.dispatch_battery

    def keep(*args, **kw):
        capture.setdefault("dispatch", args)
        return kernel(*args, **kw)

    dispatch.dispatch_battery = keep
    try:
        yield
    finally:
        dispatch.dispatch_battery = kernel


def run_path(sim) -> dict:
    """Run every model year of ``sim`` with the launch counts set to 0
    before and read after; returns the results, per-year seconds, wall,
    launch counts and first-launch operands (the first battery dispatch's
    among them)."""
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
        with first_dispatch(bk.CAPTURE):
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


def sm_clock_mhz_under(fn) -> float:
    """The SM clock nvidia-smi reads while ``fn`` is launched back to back
    (at most 2,000 launches)."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    for _ in range(2000):
        if proc.poll() is not None:
            break
        fn()
    out = proc.communicate(timeout=60)[0]
    torch.cuda.synchronize()
    return float(out.strip().splitlines()[0])


def dispatch_row(ops: tuple, launches: int) -> dict:
    """The dispatch kernel against its plain loop on ``ops``, bit for
    bit, both timed, its bound: the larger of its bytes (load and gen
    read, the four outputs written, the three [N] battery inputs read, at
    4 bytes; DISPATCH_OPS float32 operations an (agent, hour) take less)
    and its serial chain (DISPATCH_CHAIN dependent instructions of
    DEPENDENT_CYCLES an hour at the SM clock read under load); and the
    kernel on the first warp of agents alone (its chain in practice,
    logged)."""
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
    mhz = sm_clock_mhz_under(lambda: dispatch.dispatch_battery(*ops))
    t_bytes = 4.0 * (6 * n * hours + 3 * n) / PEAK_BYTES_PER_S * 1e3
    t_ops = float(n) * hours * DISPATCH_OPS / PEAK_F32_FLOPS * 1e3
    t_chain = float(hours) * DISPATCH_CHAIN * DEPENDENT_CYCLES / (mhz * 1e6) * 1e3
    b_ms, b_by = max((t_bytes, "bytes"), (t_ops, "operations"),
                     (t_chain, "operations"))
    warp = tuple(t[:32] for t in ops)
    warp_ms = time_ms(lambda: dispatch.dispatch_battery(*warp))
    log(f"  battery_dispatch: N={n} H={hours} equal to the plain loop bit for bit "
        f"(torch.equal, every output) kernel {ms:.3f} ms | plain {plain_ms:.3f} ms "
        f"| bound {b_ms:.3f} ms ({'bytes' if b_ms == t_bytes else 'serial chain'}; "
        f"bytes {t_bytes:.3f} ms, serial chain {t_chain:.3f} ms = {DISPATCH_CHAIN} "
        f"dependent instructions x {DEPENDENT_CYCLES} cycles x {hours} hours at "
        f"{mhz:.0f} MHz under load); one warp of 32 agents alone (the serial "
        f"chain in practice) {warp_ms:.3f} ms")
    return dict(name="battery_dispatch", route="cuda", source=SOURCES["dispatch"],
                replaces="dgen_tpu/ops/dispatch.py:88", launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape_n_hours=[n, hours],
                sm_clock_mhz=mhz, serial_chain_ms=warp_ms, path="main")


def dispatch_every_path(captures: dict) -> None:
    """The dispatch kernel against its plain loop, bit for bit, on the
    first battery dispatch of every model path (every path but the
    micro-benchmark's, which runs no model year); logged, a mismatch or a
    model path with no captured dispatch fails the run."""
    import torch

    from dgen_tpu_torch.ops import dispatch

    for path, cap in captures.items():
        if path == "micro":
            continue
        if "dispatch" not in cap:
            raise AssertionError(f"the {path} path captured no battery dispatch")
        ops = cap["dispatch"]
        got = dispatch.dispatch_battery(*ops)
        ref = dispatch.dispatch_battery_plain(*ops)
        torch.cuda.synchronize()
        for k in ("system_out", "soc", "charge", "discharge"):
            if not torch.equal(getattr(got, k), getattr(ref, k)):
                raise AssertionError(f"battery_dispatch on the {path} path: {k} "
                                     "differs from the plain loop")
        log(f"  battery_dispatch on the {path} path's first dispatch: "
            f"N={ops[0].shape[0]} H={ops[0].shape[1]}, equal to the plain loop bit "
            "for bit (torch.equal, every output)")
        del got, ref
        torch.cuda.empty_cache()


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


def same_bits(got, ref) -> bool:
    """Every output equal bit for bit (signed zeros included)."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
               for a, b in zip(got, ref, strict=True))


def staging_ab(captures: dict) -> None:
    """The stream kernel against the month kernel on the gated path's and
    the int8-banks path's own operands, and the pair kernel against two
    month launches (one a tariff) on both rate-switch paths' operands:
    bit for bit, and both sides timed in alternated pairs; a mismatch
    fails the run."""
    from dgen_tpu_torch.ops import billkernels as bk
    from dgen_tpu_torch.tools.kernel_microbench import ab_ms

    for name, (path, key) in (
            ("stream imports, gated", ("gated", "stream")),
            ("stream signed, gated", ("gated", "stream_signed")),
            ("stream imports, int8 packs", ("quant", "stream/int8"))):
        args = captures[path][key]
        if not same_bits(bk.stream_sums(*args), bk.month_sums(*args)):
            raise AssertionError(f"{name}: the stream kernel differs from the "
                                 "month kernel on the same operands")
        ms, month_ms, wins = ab_ms(lambda: bk.stream_sums(*args),
                                   lambda: bk.month_sums(*args))
        log(f"  {name}: N={args[0].shape[0]} R={args[4].shape[1]} "
            f"lanes={args[0].shape[1]}: equal to the month kernel bit for bit; "
            f"stream kernel {ms:.3f} ms | month kernel {month_ms:.3f} ms "
            f"(medians of 6 alternated pairs; stream faster in {wins})")
    for path in ("switch", "switch_gated"):
        load, gen, sa, pa, sb, pb, scales, offsets, p = captures[path]["month_pair"]

        def two():
            return (bk.month_sums(load, gen, sa, pa, scales, offsets, p, False)
                    + bk.month_sums(load, gen, sb, pb, scales, offsets, p, False))

        def pair():
            return bk.month_pair_sums(load, gen, sa, pa, sb, pb, scales, offsets, p)

        name = f"pair, {path}"
        if not same_bits(pair(), two()):
            raise AssertionError(f"{name}: the pair kernel differs from two month "
                                 "launches on the same operands")
        ms, month_ms, wins = ab_ms(pair, two)
        log(f"  {name}: N={load.shape[0]} R={scales.shape[1]} lanes={load.shape[1]}: "
            f"equal to two month launches bit for bit; pair kernel {ms:.3f} ms | "
            f"two month launches {month_ms:.3f} ms (medians of 6 alternated "
            f"pairs; pair faster in {wins})")


#: the pieces of a model year the profiled year names, by module and
#: function: (label, module path, attribute)
YEAR_PIECES = (
    ("apply_year", "dgen_tpu_torch.models.simulation", "apply_year"),
    ("nem_gate", "dgen_tpu_torch.models.simulation", "compute_nem_allowed"),
    ("build_econ_inputs", "dgen_tpu_torch.models.simulation", "build_econ_inputs"),
    ("size_agents", "dgen_tpu_torch.ops.sizing", "size_agents"),
    ("linear_sums", "dgen_tpu_torch.ops.billkernels", "linear_sums"),
    ("pack_streams", "dgen_tpu_torch.ops.billkernels", "pack_streams"),
    ("import_sums", "dgen_tpu_torch.ops.billkernels", "import_sums"),
    ("bucket_sums", "dgen_tpu_torch.ops.billkernels", "bucket_sums"),
    ("bills_linear_nb", "dgen_tpu_torch.ops.billkernels", "bills_linear_nb"),
    ("bills_linear_nem", "dgen_tpu_torch.ops.billkernels", "bills_linear_nem"),
    ("bills_from_sums", "dgen_tpu_torch.ops.billkernels", "bills_from_sums"),
    ("cashflow", "dgen_tpu_torch.ops.sizing", "cashflow"),
    ("payback_period", "dgen_tpu_torch.ops.sizing", "payback_period"),
    ("dispatch_battery", "dgen_tpu_torch.ops.dispatch", "dispatch_battery"),
    ("net_hourly_profiles", "dgen_tpu_torch.ops.sizing", "net_hourly_profiles"),
    ("max_market_share", "dgen_tpu_torch.models.simulation", "max_market_share"),
    ("diffusion_step", "dgen_tpu_torch.models.simulation", "diffusion_step"),
    ("allocate_battery", "dgen_tpu_torch.models.simulation",
     "allocate_battery_adopters"),
)


def profile_year(sim, title: str) -> None:
    """One carry year of ``sim`` (its first year run just before, outside
    the trace) under torch.profiler, its outputs collected to the host as
    Simulation.run collects them. Logs the ten device operations that
    took most time with their launch counts, kernel (and copy) time
    against the year's wall time, the device's idle share over that wall
    time (1 - the union of device intervals / wall), and per piece of the
    year (YEAR_PIECES, each wrapped in a record_function range for the
    trace) its calls, host time and device time."""
    import dataclasses
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from dgen_tpu_torch.models.simulation import YearOutputs

    def labelled(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    originals = []
    for label, mod, attr in YEAR_PIECES:
        m = importlib.import_module(mod)
        originals.append((m, attr, getattr(m, attr)))
        setattr(m, attr, labelled(label, getattr(m, attr)))
    fields = [f.name for f in dataclasses.fields(YearOutputs)]
    step = type(sim).step
    try:
        carry, _ = step(sim, sim.init_carry(), 0, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, outs = step(sim, carry, 1, False)
            with record_function("collect"):
                for k in fields:
                    v = getattr(outs, k)
                    if v is not None:
                        v.cpu().numpy()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for m, attr, fn in originals:
            setattr(m, attr, fn)
    labels = {label for label, _, _ in YEAR_PIECES} | {"collect"}
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in labels]
    if not device:
        raise AssertionError(f"{title}: the profiler recorded no device operation")
    by_name: dict = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    copies = sum(us for name, (_, us) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    kernels = sum(us for _, us in by_name.values()) - copies
    log(f"[9c] profiled carry year, {title}: wall {wall_us / 1e3:.3f} ms; device "
        f"kernels {kernels / 1e3:.3f} ms, copies {copies / 1e3:.3f} ms; device busy "
        f"(union of intervals) {busy / 1e3:.3f} ms, idle share "
        f"{1.0 - busy / wall_us:.3f}; {sum(n for n, _ in by_name.values())} device "
        f"operations of {len(by_name)} kinds; the ten longest:")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"    {us / 1e3:8.3f} ms  {n:4d} x  {name[:110]}")
    log("    pieces of the year (host ms inclusive, device ms of the kernels "
        "they launched):")
    for label in [lb for lb, _, _ in YEAR_PIECES] + ["collect"]:
        hits = [e for e in events if e.name == label
                and e.device_type == DeviceType.CPU]
        if not hits:
            continue
        dev_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total for e in hits)
        log(f"    {label:20s} {len(hits):3d} calls  host {sum(e.cpu_time_total for e in hits) / 1e3:8.3f} ms  "
            f"device {dev_us / 1e3:8.3f} ms")


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
        with first_dispatch(bk.CAPTURE):
            dot = national(one_year("dot"))
    finally:
        launches = {**bk.LAUNCHES, **dispatch.LAUNCHES}
        capture, bk.CAPTURE = bk.CAPTURE, None
    return launches, capture, curves_gap(dot, ref), dot, ref


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "parent"),
        help="another checkout whose sums_variant and sums_monthdot kernels "
             "[9] times against this one's (skipped where absent)")
    parent_root = ap.parse_args(argv).parent
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
    micro_library = micro_library_ms(captures["micro"]["variant"], mk)
    rows = check_and_time(captures, kernel_specs(bk, mk), hour_lanes, micro_library)
    parent_ab(captures["micro"]["variant"], parent_root)
    monthdot_month_ab(captures["micro"]["variant"], mk)
    log("  A/Bs, not in the kernels line: the month kernel on the stream kernel's "
        "operands (the gated path launches no month kernel), and the narrow rows' "
        "kernels on float32 copies of their operands (equal operations):")
    float32_copies(captures)
    ab = check_and_time(captures, ab_specs(bk), hour_lanes)[0]
    log("  the redesigned kernels on their paths' own operands against the month "
        "kernel, bit for bit (same_bits) and timed, not in the kernels line:")
    staging_ab(captures)
    dot_month_ab(captures)
    log("  the battery dispatch kernel on every model path's first dispatch:")
    dispatch_every_path(captures)
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

    # --- 9c: one carry year of the default and the gated path, traced ---
    profile_year(sim, f"default path, {MAIN_AGENTS} agents")
    profile_year(gsim, f"gated path, {MAIN_AGENTS} agents")

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
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
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
