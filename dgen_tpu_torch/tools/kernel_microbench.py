"""Micro-benchmark of the bucket-sums kernel variants: the counterpart of
``tools/kernel_microbench.py``.

Isolates where a bucket-sums kernel's time goes (forming the one-hot
matrix M, forming relu(net), the tensor-core product) and times
alternative designs beside the engines the model year runs, in one call
on one card:

  * the seven settings of :func:`microkernels.sums_variant` (the one-hot
    tensor-core kernel with its stages switched off one by one);
  * ``monthmask``, ``mg4``, ``mg8`` (month-masked sums, one agent or
    4 / 8 agents per block) and ``monthdot`` (month-blocked product);
  * ``monthdot_pre`` (relu(net) times prebuilt mask columns on the
    tensor cores), ``mnet`` and ``mnet_hi`` (net itself a rank-1
    tensor-core product, in TF32 and in 3xTF32); the mask columns M
    [N, 8, 8760] are built once per run, outside the timed calls, and
    the build is timed and printed on its own line;
  * ``compact``: the month engine under the daylight-compacted layout of
    the synthetic generation (zero outside 06:00-18:00), night sums added
    back; ``stream``: the segment-streaming engine, full-hour and on the
    uniform compacted segments, with its modeled lane operations and
    stream bytes; ``quant``: int8 load and gen codes (per-agent scales
    folded into the scales) through the unchanged month engine, with the
    stream bytes beside the float32 ones; ``lib``: the month engine,
    full-hour;
  * ``piecewise`` (only when named): the sorted-hinge formulation in plain
    PyTorch, no kernel.

Each variant is timed with CUDA events (median of ``reps`` calls after a
warm-up) on data made on the device from a seed, and the variants that
compute the real function are held against ``lib`` on the first 32
agents. Every call gets the same scales: nothing between the caller and
the card caches a launch's result, so there is nothing to defeat. With
``--device cpu`` the plain PyTorch versions run and the times are host
times.

Usage: python -m dgen_tpu_torch.tools.kernel_microbench [n_agents]
       [variant ...] [--device cuda|cpu] [--reps N] [--seed N]

A name selects the ``sums_variant`` settings whose name contains it and
any other variant of exactly that name (``monthmask``, ``mg4``, ``mg8``,
``monthdot``, ``monthdot_pre``, ``mnet``, ``mnet_hi``, ``compact``,
``stream``, ``quant``, ``lib``, ``piecewise``, ``parity``); no name runs
all but ``piecewise``; an unknown name is an error.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import microkernels as mk
from dgen_tpu_torch.ops.layout import daylight_layout
from dgen_tpu_torch.ops.tariff import HOURS, MONTHS

N_PERIODS = 2
N_SCALES = 250
#: agents of the slice every parity line compares on
PARITY_AGENTS = 32

#: settings of ``sums_variant``, selected by substring; True = the setting
#: computes the real function and gets a parity line
SUMS_VARIANTS = {
    "base(onehot,dot,fma,128)": (dict(), True),
    "const_m(no onehot build)": (dict(build="const"), False),
    "no_dot(onehot, no MXU)": (dict(dot="none"), False),
    "no_dot_const(no build,no MXU)": (dict(build="const", dot="none"), False),
    "no_net(onehot,dot,bcast)": (dict(net="bcast"), False),
    "b64(onehot,dot,fma,64)": (dict(b_pad=64), True),
    "b64_const": (dict(b_pad=64, build="const"), False),
}
#: variants selected by their exact name
EXACT_NAMES = ("monthmask", "mg4", "mg8", "monthdot", "monthdot_pre", "mnet",
               "mnet_hi", "piecewise", "compact", "stream", "quant", "lib",
               "parity")
#: rows of the prebuilt mask columns of monthdot_pre and mnet
C_PAD = 8

#: parity against ``lib``, by kind: rtol, with atol ATOL_FRAC x the agent's
#: largest |lib| value in that output. "mask": float32 sums in another
#: order (3xTF32 products too); "dot": TF32 products (10 mantissa bits);
#: "int8": load and gen rounded to 1/254 of each agent's range, held to
#: the JAX package's int8 envelope of 2% (tests/test_roofline.py)
PARITY_RTOL = {"mask": 1e-4, "dot": 5e-3, "int8": 2e-2}
ATOL_FRAC = 1e-3


def sums_piecewise(load, gen, sell, bucket_id, scales, *, n_periods=2):
    """Exact piecewise-linear formulation in plain PyTorch:
    ``imports_b(s) = L_b(s) - s * G_b(s)`` with L / G the sums of load /
    gen over the bucket's hours whose ratio load / gen exceeds s. Per
    agent: the hours are binned by the number of sorted scales below
    their ratio, the four weighted streams are scatter-added into
    (bucket, bin) cells, and suffix sums over the bins give every scale
    its bucket row: O(H log R + B R) per agent instead of O(H R).
    Returns (imports [N, R, 12P], imp_sell [N, R])."""
    n, h = load.shape
    r = scales.shape[1]
    nb = MONTHS * n_periods

    no_gen = gen <= 0
    ratio = torch.where(no_gen, torch.full_like(load, torch.inf),
                        load / torch.clamp_min(gen, 1e-30))
    gen = torch.where(no_gen, torch.zeros_like(gen), gen)
    s_sorted, order = torch.sort(scales, dim=1, stable=True)
    k = torch.searchsorted(s_sorted, ratio)             # [N, H] in 0..R
    bins = bucket_id.long() * (r + 1) + k

    def seg(x):
        out = torch.zeros((n, nb * (r + 1)), dtype=x.dtype, device=x.device)
        return out.scatter_add_(1, bins, x).view(n, nb, r + 1)

    def suffix(w):
        # hours active for sorted scale j are those with k > j
        return w.flip(-1).cumsum(-1).flip(-1)[..., 1:]

    imports_sorted = (suffix(seg(load))
                      - s_sorted[:, None, :] * suffix(seg(gen)))    # [N, nb, R]
    sell_sorted = (suffix(seg(sell * load).sum(dim=1))
                   - s_sorted * suffix(seg(sell * gen).sum(dim=1)))  # [N, R]
    inv = torch.argsort(order, dim=1)
    imports = torch.gather(imports_sorted, 2, inv[:, None, :].expand(n, nb, r))
    return (imports.transpose(1, 2).contiguous(),
            torch.gather(sell_sorted, 1, inv))


def day_mask() -> np.ndarray:
    """[8760] float32, 1 in the hours 06:00-18:00 of every day."""
    hod = np.arange(HOURS) % 24
    return ((hod >= 6) & (hod < 18)).astype(np.float32)


def make_data(n: int, device, seed: int = 0, n_periods: int = N_PERIODS,
              r: int = N_SCALES) -> tuple:
    """(load, gen, sell, bucket_id, scales) made on ``device`` from
    ``seed``: load U(0.2, 3), gen U(0, 1) inside the daylight window and 0
    outside it, sell U(0.02, 0.08), a uniform period per hour, scales
    U(0.1, 6)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    load = uniform((n, HOURS), 0.2, 3.0)
    gen = uniform((n, HOURS), 0.0, 1.0) * torch.from_numpy(day_mask()).to(device)
    sell = uniform((n, HOURS), 0.02, 0.08)
    period = torch.randint(0, n_periods, (n, HOURS), generator=g, device=device,
                           dtype=torch.int32)
    bucket = bk.hourly_bucket_ids(period, n_periods)
    return load, gen, sell, bucket, uniform((n, r), 0.1, 6.0)


def time_ms(fn, reps: int, device) -> float:
    """Median ms of ``reps`` calls after a warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bad_agents(got: torch.Tensor, ref: torch.Tensor, rtol: float) -> int:
    """Agents with an element outside rtol + ATOL_FRAC x that agent's
    largest |ref| in this output."""
    row_max = ref.abs().flatten(1).amax(1).view(-1, *[1] * (ref.ndim - 1))
    tol = rtol * ref.abs() + ATOL_FRAC * row_max
    return int(((got - ref).abs() > tol).flatten(1).any(1).sum())


def check_parity(name: str, fn, data, kind: str, k: int = PARITY_AGENTS) -> dict:
    """One variant against the month engine on the first ``k`` agents:
    prints the tool's parity line and returns its numbers and the agents
    outside the kind's tolerance."""
    part = tuple(d[:k] for d in data)
    ref = bk.import_sums(*part, MONTHS * N_PERIODS)
    got = fn(*part)
    err_b = float((got[0] - ref[0]).abs().max())
    err_s = float((got[1] - ref[1]).abs().max())
    rel = err_b / max(float(ref[0].abs().max()), 1e-9)
    rtol = PARITY_RTOL[kind]
    bad = max(bad_agents(g, rf, rtol) for g, rf in zip(got, ref))
    print(f"parity {name} vs lib: max|d| buckets {err_b:.3e} (rel {rel:.2e}) "
          f"sell {err_s:.3e}", flush=True)
    return dict(max_abs_buckets=err_b, rel_buckets=rel, max_abs_sell=err_s,
                kind=kind, rtol=rtol, agents=part[0].shape[0], bad_agents=bad)


def quantize(x: torch.Tensor) -> tuple:
    """(int8 codes, [N] float32 scales) of ``x`` [N, H], row by row, as the
    JAX tool's ``quant`` variant quantizes: scale = max(max|x|, 1e-9) /
    127, codes = clip(round(x / scale), -127, 127)."""
    scale = torch.clamp_min(x.abs().amax(dim=1), 1e-9) / 127.0
    codes = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale


def _check_names(which: set) -> None:
    unknown = sorted(w for w in which if w not in EXACT_NAMES
                     and not any(w in name for name in SUMS_VARIANTS))
    if unknown:
        raise ValueError(f"no variant is named {unknown}; names: "
                         f"{list(SUMS_VARIANTS)} (by substring), {EXACT_NAMES}")


def run(n_agents: int = 8192, which=(), device="cuda", reps: int = 5,
        seed: int = 0) -> dict:
    """Runs the variants ``which`` selects (all but ``piecewise`` when
    empty) at ``n_agents`` x 250 scales x 8760 hours, P = 2, printing the
    tool's lines; ``ValueError`` for an unknown name. Returns ``{"device", "timed_on", "n_agents", "variants":
    {name: {"ms", "parity" or None}}}``; ``parity`` is
    :func:`check_parity`'s dict."""
    which = set(which)
    _check_names(which)
    dev = resolve_device(device)
    timed_on = "device" if dev.type == "cuda" else "cpu"
    if not which:
        print(f"kernel_microbench on {dev}: every variant but piecewise",
              flush=True)
    data = make_data(n_agents, dev, seed)
    nb = MONTHS * N_PERIODS
    variants: dict = {}

    def measure(name, fn, parity_name=None, kind="mask"):
        ms = time_ms(lambda: fn(*data), reps, dev)
        print(f"{name:34s} {ms:8.2f} ms/call {timed_on}", flush=True)
        parity = (check_parity(parity_name, fn, data, kind)
                  if parity_name is not None else None)
        variants[name] = dict(ms=ms, parity=parity)

    for name, (kw, real) in SUMS_VARIANTS.items():
        if which and not any(w in name for w in which):
            continue
        measure(name,
                lambda l, g, s, b, sc, kw=kw: mk.sums_variant(
                    l, g, s, b, sc, n_periods=N_PERIODS, **kw),
                name.split("(")[0] if real else None, "dot")

    def monthmask(l, g, s, b, sc):
        return mk.sums_monthmask(l, g, s, b, sc, n_periods=N_PERIODS)

    if not which or "monthmask" in which:
        measure("monthmask(no onehot,no MXU)", monthmask, "monthmask")
    elif "parity" in which:
        check_parity("monthmask", monthmask, data, "mask")

    for g_block in (4, 8):
        if not which or f"mg{g_block}" in which:
            measure(f"monthmask_g{g_block}",
                    lambda l, g, s, b, sc, g_block=g_block: mk.sums_monthmask_g(
                        l, g, s, b, sc, n_periods=N_PERIODS, g_block=g_block),
                    f"mg{g_block}")

    if not which or "monthdot" in which:
        measure("monthdot(positional M,dot)",
                lambda l, g, s, b, sc: mk.sums_monthdot(
                    l, g, s, b, sc, n_periods=N_PERIODS),
                "monthdot", "dot")

    pre_names = ("monthdot_pre", "mnet", "mnet_hi")
    if not which or which & set(pre_names):
        t0 = time.perf_counter()
        m_pre = mk.build_mask_cols(data[2], data[3] % N_PERIODS, N_PERIODS, C_PAD)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"mask columns M [{n_agents}, {C_PAD}, {HOURS}]: "
              f"{m_pre.numel() * 4 / 1e6:.0f} MB, built in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, once, "
              "outside the timed calls)", flush=True)

        def pre(fn, **kw):
            # the first k agents' rows of M for the parity slice
            return lambda l, g, s, b, sc: fn(l, g, s, b, sc, n_periods=N_PERIODS,
                                             c_pad=C_PAD,
                                             prebuilt=m_pre[:l.shape[0]], **kw)

        if not which or "monthdot_pre" in which:
            measure("monthdot_pre(prebuilt M,MXU)", pre(mk.sums_monthdot_pre),
                    "monthdot_pre", "dot")
        for name, hi in (("mnet", False), ("mnet_hi", True)):
            if not which or name in which:
                measure(f"{name}(rank-1 MXU net{'/hi' if hi else ''})",
                        pre(mk.sums_mnet, hi=hi), name, "mask" if hi else "dot")
        del m_pre

    if "piecewise" in which:
        measure("piecewise(sorted-hinge,plain)",
                lambda l, g, s, b, sc: sums_piecewise(
                    l, g, s, b, sc, n_periods=N_PERIODS),
                "piecewise")

    lay = daylight_layout(day_mask()[None, :])
    if not which or "compact" in which:
        print(f"daylight layout: {lay.n_lanes} compacted lanes for {HOURS} hours "
              f"({HOURS / lay.n_lanes:.2f}x fewer candidate lane operations)",
              flush=True)
        measure("compact(daylight seg+night sums)",
                lambda l, g, s, b, sc: bk.import_sums(l, g, s, b, sc, nb,
                                                      layout=lay),
                "compact")

    if not which or "stream" in which:
        for name, lay_s in (("stream(full-hour dbuf)", None),
                            ("stream_compact(uniform dbuf)", lay.uniform())):
            lanes = HOURS if lay_s is None else lay_s.n_lanes
            lane_ops = (4 + 2 * N_PERIODS) * n_agents * N_SCALES * lanes
            stream_bytes = 4 * n_agents * lanes * 4
            print(f"{name}: {lanes} lanes, ~{lane_ops / 1e9:.1f}G lane operations "
                  f"({4 + 2 * N_PERIODS} per scale and lane), "
                  f"~{stream_bytes / 1e6:.0f} MB stream reads per call", flush=True)
            measure(name,
                    lambda l, g, s, b, sc, lay_s=lay_s: bk.import_sums(
                        l, g, s, b, sc, nb, impl="stream", layout=lay_s),
                    name)

    if not which or "quant" in which:
        stream_bytes = n_agents * HOURS * (1 + 1 + 4 + 4)
        print(f"quant: int8 load/gen codes, ~{stream_bytes / 1e6:.0f} MB stream "
              f"reads per call (f32: {n_agents * HOURS * 16 / 1e6:.0f} MB)",
              flush=True)

        def quant(l, g, s, b, sc):
            # quantized inside the timed call, as the JAX tool does: an
            # O(N H) pass beside the kernel's O(N R H)
            lq, ls = quantize(l)
            gq, gs = quantize(g)
            return bk.import_sums(lq, gq, s, b, sc, nb, load_scale=ls, gen_scale=gs)

        measure("quant(int8 streams)", quant, "quant", "int8")

    if not which or "lib" in which:
        measure("library month engine",
                lambda l, g, s, b, sc: bk.import_sums(l, g, s, b, sc, nb))

    return dict(device=str(dev), timed_on=timed_on, n_agents=n_agents,
                n_scales=N_SCALES, n_periods=N_PERIODS, reps=reps,
                variants=variants)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.tools.kernel_microbench",
        description="Time the bucket-sums kernel variants on one device.")
    ap.add_argument("n_agents", nargs="?", type=int, default=8192)
    ap.add_argument("variants", nargs="*",
                    help="names to run (default: all but piecewise)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        run(args.n_agents, args.variants, device=args.device, reps=args.reps,
            seed=args.seed)
    except ValueError as e:
        print(f"kernel_microbench: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
