"""Plain PyTorch functions of this checkout against those of another
checkout of the repository, in one process, on the same operands.

    python -m dgen_tpu_torch.tools.plain_parent_ab OTHER_ROOT
        [--agents N] [--pairs K] [--device cuda|cpu]

``OTHER_ROOT`` is the root of the other checkout, for example a ``git
archive`` of the parent commit unpacked into a git-ignored directory.
Each function of :data:`SWAPS` is loaded from the other checkout's
source file of its module (under a name of its own, so this checkout's
modules stay as they are) and put in place of this checkout's wherever
the model year looks it up, for the "other" side of every comparison.

The pieces of :data:`PIECES` are called with the operands of their first
call in one first model year of the ercot-all-sector world at
``--agents`` agents; each piece, and one carry year of the whole step
(the second model year, from the first year's carry), runs once on
each side, the outputs are compared (the largest absolute and relative
differences, and whether they are equal bit for bit), and both sides
are timed in ``--pairs`` alternated pairs (medians of 5 calls each:
CUDA events on a card). The card's name and power limit are printed
beside the times; one JSON line comes last.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys

import torch

from dgen_tpu_torch import presets
from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.tools import kernel_microbench as tool

#: (module whose attribute is swapped, attribute, the file of the other
#: checkout it is loaded from): the month x period sums and the tiered
#: charges of the linear bill identities
SWAPS = (
    ("dgen_tpu_torch.ops.bill", "monthly_period_sums", "dgen_tpu_torch/ops/bill.py"),
    ("dgen_tpu_torch.ops.billkernels", "monthly_period_sums",
     "dgen_tpu_torch/ops/bill.py"),
    ("dgen_tpu_torch.ops.billkernels", "_tier_charge_batched",
     "dgen_tpu_torch/ops/billkernels.py"),
)
#: the billkernels entries timed on their first call's operands
PIECES = ("linear_sums", "bills_linear_nb")


def other_functions(root: str) -> list:
    """``[(module, attribute, the other checkout's function)]`` for
    :data:`SWAPS`; each file is executed once, as a module named after
    its path under ``other_``."""
    loaded = {}
    out = []
    for mod, attr, rel in SWAPS:
        if rel not in loaded:
            name = "other_" + rel.replace("/", "_").removesuffix(".py")
            spec = importlib.util.spec_from_file_location(name, os.path.join(root, rel))
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module      # its dataclasses look it up
            spec.loader.exec_module(module)
            loaded[rel] = module
        out.append((importlib.import_module(mod), attr, getattr(loaded[rel], attr)))
    return out


@contextlib.contextmanager
def swapped(functions: list):
    """The other checkout's functions in place inside the block."""
    own = [(m, a, getattr(m, a)) for m, a, _ in functions]
    for m, a, f in functions:
        setattr(m, a, f)
    try:
        yield
    finally:
        for m, a, f in own:
            setattr(m, a, f)


def first_calls(sim) -> dict:
    """Piece -> (args, kwargs) of its first call in the first model year
    of ``sim`` (this checkout's functions)."""
    calls = {}
    own = {p: getattr(bk, p) for p in PIECES}

    def keep(piece):
        def call(*args, **kw):
            calls.setdefault(piece, (args, kw))
            return own[piece](*args, **kw)
        return call

    for p in PIECES:
        setattr(bk, p, keep(p))
    try:
        sim.step(sim.init_carry(), 0, True)
    finally:
        for p, f in own.items():
            setattr(bk, p, f)
    return calls


def leaves(x) -> list:
    """The tensors of an output (a tensor, a tuple or a dataclass tree)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def differences(mine, theirs) -> dict:
    """Largest absolute and relative differences, and bit equality."""
    a, b = leaves(mine), leaves(theirs)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError("the two checkouts' outputs differ in structure")
    abs_d = rel_d = 0.0
    for x, y in zip(a, b):
        if x.is_floating_point():
            d = (x.double() - y.double()).abs()
            abs_d = max(abs_d, float(d.max()) if d.numel() else 0.0)
            scale = y.double().abs().clamp_min(1e-30)
            rel_d = max(rel_d, float((d / scale).max()) if d.numel() else 0.0)
    return dict(max_abs_diff=abs_d, max_rel_diff=rel_d,
                same_bits=all(torch.equal(x, y) for x, y in zip(a, b)))


def compare_and_time(fn, functions: list, pairs: int, device) -> dict:
    """``fn`` on each side once (compared), then timed in alternated pairs."""
    mine = fn()
    with swapped(functions):
        theirs = fn()
    row = differences(mine, theirs)
    del mine, theirs

    def other():
        with swapped(functions):
            fn()

    ms, other_ms, wins = tool.ab_ms(fn, other, pairs, torch.device(device))
    return dict(row, ms=ms, other_ms=other_ms, wins=wins, pairs=pairs)


def run(other_root: str, n_agents: int = 8192, pairs: int = 6,
        device="cuda") -> dict:
    """Piece (and ``"carry_year"``) -> its comparison and times."""
    device = torch.device(device)
    functions = other_functions(other_root)
    sim, _, _ = presets.build("ercot-all-sector", n_agents=n_agents,
                              end_year=2016, device=device)
    rows = {}
    for piece, (args, kw) in first_calls(sim).items():
        rows[piece] = compare_and_time(
            lambda p=piece, a=args, k=kw: getattr(bk, p)(*a, **k), functions,
            pairs, device)
    carry, _ = sim.step(sim.init_carry(), 0, True)
    rows["carry_year"] = compare_and_time(lambda: sim.step(carry, 1, False),
                                          functions, pairs, device)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--agents", type=int, default=8192)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.other_root, args.agents, args.pairs, args.device)
    card = presets.device_label(torch.device(args.device))
    for name, r in rows.items():
        print(f"{name} at {args.agents} agents: this checkout {r['ms']:.3f} ms | "
              f"other {r['other_ms']:.3f} ms (this faster in {r['wins']} of "
              f"{r['pairs']} alternated pairs); outputs differ by at most "
              f"{r['max_abs_diff']:.3e} ({r['max_rel_diff']:.3e} relative), equal "
              f"bit for bit: {r['same_bits']}; on {card}", flush=True)
    print(json.dumps({"card": card, "agents": args.agents, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
