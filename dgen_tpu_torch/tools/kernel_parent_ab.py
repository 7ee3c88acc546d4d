"""The kernels of this checkout against those of another checkout of the
repository, on the same operands, on one NVIDIA GPU.

    python -m dgen_tpu_torch.tools.kernel_parent_ab OTHER_ROOT
        [--agents N] [--sizing-impl stream|dot] [--knob NAME ...]
        [--kernels KEY ...] [--first-agents K] [--rtol X --atol Y]
        [--seed S]

``OTHER_ROOT`` is the root of the other checkout, for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory. Its
``dgen_tpu_torch/csrc`` is built as this checkout's is (``ops/_build``,
this checkout's flags) into a library of its own; a kernel is compared
only where its C entry kept its signature.

The operands of an engine kernel are those of its first launch in one
model year of the ercot-all-sector world at ``--agents`` agents, through
``year_step`` with the ``--knob`` run options set (``daylight_compact``,
``pack_once``, ``stream_segments``, ...) and, where given, the
``--sizing-impl`` in place of the one those options choose. The
micro-benchmark's kernels (:data:`MICRO_KERNELS`: ``variant``,
``monthdot``, ``monthmask``, ``monthmask_g``, ``monthdot_pre``,
``mnet``, ``mnet_hi``) take the micro-benchmark's own operands instead,
``kernel_microbench.make_data`` at ``--agents`` agents and ``--seed``,
in the tool's default setting of each. Each kernel named in
``--kernels`` (the launch-count keys: ``month``, ``month_signed``,
``stream``, ``dot``, ``dispatch``, ``variant``, ...; every kernel the
year launched by default) runs through its own wrapper once with this
checkout's library and once with the other's; both are held to the
wrapper's plain version (the largest absolute error, and with ``--rtol``
and ``--atol`` the largest ratio of error to ``atol + rtol x |plain|``
and the agents outside rtol plus a per-agent atol of
``kernel_microbench.ATOL_FRAC`` x the agent's largest |plain|) and to
each other (bit for bit or not), then timed in 6 alternated pairs
(medians of 5 CUDA-event launches each), on all agents and, with
``--first-agents``, on the first K agents' rows alone. The card's name
and power limit are printed beside the times; one JSON line comes last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys

import torch

from dgen_tpu_torch import presets
from dgen_tpu_torch.config import RunConfig
from dgen_tpu_torch.models.simulation import year_step
from dgen_tpu_torch.ops import _build
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import dispatch
from dgen_tpu_torch.ops import microkernels as mk
from dgen_tpu_torch.tools import kernel_microbench as tool

_micro = functools.partial(functools.partial, n_periods=tool.N_PERIODS)
#: the micro-benchmark's launch-count keys -> (wrapper, plain version) in
#: the tool's default setting; the prebuilt-mask kernels take (load, gen,
#: M, scales), the others (load, gen, sell, bucket ids, scales)
MICRO_KERNELS = {
    "variant": (_micro(mk.sums_variant), _micro(mk.sums_variant_plain)),
    "monthdot": (_micro(mk.sums_monthdot), _micro(mk.sums_monthdot_plain)),
    "monthmask": (_micro(mk.sums_monthmask), _micro(mk.sums_monthmask_plain)),
    "monthmask_g": (_micro(mk.sums_monthmask_g, g_block=8),
                    _micro(mk.sums_monthmask_g_plain, g_block=8)),
    "monthdot_pre": (_micro(mk.monthdot_pre_sums), _micro(mk.mask_product_plain)),
    "mnet": (_micro(mk.mnet_sums), _micro(mk.mask_product_plain)),
    "mnet_hi": (_micro(mk.mnet_sums, hi=True), _micro(mk.mask_product_plain)),
}
_PREBUILT = ("monthdot_pre", "mnet", "mnet_hi")

#: launch-count key -> (wrapper, plain version)
KERNELS = {
    "month": (bk.month_sums, bk.month_sums_plain),
    "month_signed": (bk.month_sums, bk.month_sums_plain),
    "month_pair": (bk.month_pair_sums, bk.month_pair_sums_plain),
    "stream": (bk.stream_sums, bk.month_sums_plain),
    "stream_signed": (bk.stream_sums, bk.month_sums_plain),
    "dot": (bk.dot_sums, bk.dot_sums_plain),
    "dot_signed": (bk.dot_sums, bk.dot_sums_plain),
    "dispatch": (dispatch.dispatch_battery, dispatch.dispatch_battery_plain),
    **MICRO_KERNELS,
}


def micro_operands(key: str, n_agents: int, seed: int = 0, device="cuda") -> tuple:
    """The micro-benchmark kernel ``key``'s operands: the tool's data at
    ``n_agents`` agents from ``seed``, with the prebuilt mask columns M in
    place of sell and the bucket ids for the prebuilt-mask kernels."""
    load, gen, sell, bucket, scales = tool.make_data(n_agents, torch.device(device),
                                                     seed)
    if key in _PREBUILT:
        m = mk.build_mask_cols(sell, bucket % tool.N_PERIODS, tool.N_PERIODS,
                               tool.C_PAD)
        return load, gen, m, scales
    return load, gen, sell, bucket, scales


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from ``lib`` inside the block."""
    own = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = own


def outputs(res) -> tuple:
    if dataclasses.is_dataclass(res):
        return tuple(getattr(res, f.name) for f in dataclasses.fields(res))
    return tuple(res)


def first_launches(n_agents: int, sizing_impl: str | None, knobs: dict) -> dict:
    """Launch-count key -> the operands of its first launch in one model
    year (the battery dispatch's under ``"dispatch"``)."""
    sim, _, _ = presets.build("ercot-all-sector", n_agents=n_agents, end_year=2014,
                              device="cuda", run_config=RunConfig(**knobs))
    kernel = dispatch.dispatch_battery
    capture = {}

    def keep(*args, **kw):
        capture.setdefault("dispatch", args)
        return kernel(*args, **kw)

    bk.CAPTURE = capture
    dispatch.dispatch_battery = keep
    step = sim.step_kwargs(True)
    if sizing_impl is not None:
        step["sizing_impl"] = sizing_impl
    try:
        year_step(sim.table, sim.profiles, sim.tariffs, sim.inputs, sim.init_carry(),
                  0, **step)
    finally:
        bk.CAPTURE = None
        dispatch.dispatch_battery = kernel
    return {k: v for k, v in capture.items() if k in KERNELS}


def compare(key: str, args: tuple, other, rtol, atol) -> dict:
    """Both checkouts' outputs against the plain version and each other."""
    wrapper, plain = KERNELS[key]
    ref = outputs(plain(*args))
    mine = outputs(wrapper(*args))
    with using(other):
        theirs = outputs(wrapper(*args))
    torch.cuda.synchronize()
    row = dict(same_bits=all(torch.equal(a, b) for a, b in zip(mine, theirs)))
    for side, got in (("this", mine), ("other", theirs)):
        err = ratio = 0.0
        bad = 0
        for g, r in zip(got, ref):
            d = (g.float() - r.float()).abs()
            err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
            if rtol is not None:
                ratio = max(ratio, float(torch.nan_to_num(
                    d / (atol + rtol * r.float().abs()), nan=0.0).max()))
                bad = max(bad, tool.bad_agents(g.float(), r.float(), rtol))
        row[f"{side}_max_abs_err"] = err
        if rtol is not None:
            row[f"{side}_tol_ratio"] = ratio
            row[f"{side}_bad_agents"] = bad
    return row


def timed(key: str, args: tuple, other) -> dict:
    wrapper = KERNELS[key][0]

    def theirs():
        with using(other):
            wrapper(*args)

    ms, other_ms, wins = tool.ab_ms(lambda: wrapper(*args), theirs)
    return dict(ms=ms, other_ms=other_ms, wins=wins)


def first_rows(args: tuple, k: int) -> tuple:
    """``args`` with every tensor of the agents' leading dimension cut to
    its first ``k`` rows (contiguous views)."""
    n = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
    return tuple(a[:k] if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == n
                 else a for a in args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--agents", type=int, default=8192)
    ap.add_argument("--sizing-impl", choices=("auto", "stream", "dot"))
    ap.add_argument("--knob", action="append", default=[],
                    help="a boolean RunConfig field to set (repeatable)")
    ap.add_argument("--kernels", nargs="+", choices=sorted(KERNELS))
    ap.add_argument("--first-agents", type=int)
    ap.add_argument("--rtol", type=float)
    ap.add_argument("--atol", type=float)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the micro-benchmark kernels' operands")
    args = ap.parse_args(argv)
    if (args.rtol is None) != (args.atol is None):
        ap.error("--rtol and --atol go together")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    other = _build.library(os.path.join(args.other_root, "dgen_tpu_torch", "csrc"))
    keys = args.kernels
    ops = {}
    if not keys or any(k not in MICRO_KERNELS for k in keys):
        ops = first_launches(args.agents, args.sizing_impl,
                             dict.fromkeys(args.knob, True))
    rows = []
    for key in keys or sorted(ops):
        if key in MICRO_KERNELS:
            ops[key] = micro_operands(key, args.agents, args.seed)
        elif key not in ops:
            raise SystemExit(f"{key}: not launched in this model year")
        row = dict(kernel=key, agents=args.agents,
                   **compare(key, ops[key], other, args.rtol, args.atol),
                   **timed(key, ops[key], other))
        if args.first_agents:
            part = first_rows(ops[key], args.first_agents)
            row["first_agents"] = dict(agents=args.first_agents,
                                       **timed(key, part, other))
        rows.append(row)
        if key in MICRO_KERNELS:
            del ops[key]
        errs = ", ".join(f"{k} {v:.3e}" for k, v in row.items()
                         if k.endswith(("_err", "_ratio", "_bad_agents")))
        line = (f"{key} at {args.agents} agents: this checkout {row['ms']:.3f} ms | "
                f"other {row['other_ms']:.3f} ms (this faster in {row['wins']} of 6 "
                f"alternated pairs); against the plain version {errs}; equal to "
                f"each other bit for bit: {row['same_bits']}")
        if args.first_agents:
            f = row["first_agents"]
            line += (f"; first {f['agents']} agents: this {f['ms']:.3f} ms | other "
                     f"{f['other_ms']:.3f} ms (this faster in {f['wins']} of 6)")
        print(f"{line} on {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
