"""Find the first operation whose per-row result depends on the row count.

Runs one serving query bucket (``serve.engine.query_program``) over the
same requested rows at each bucket size and at a reference size, records every aten operation's
outputs with a ``TorchDispatchMode``, and compares the requested rows'
slices of each output whose leading axis is the bucket, in call order,
bit for bit. The first operation that differs is where a row's answer
starts to depend on how many rows share the launch (the serving
engine's contract is that none does).

    python -m dgen_tpu_torch.tools.row_count_probe --device cpu --agents 64 \\
        --rows 5 17 40 --buckets 4 --against 8

Prints one line per differing operation (at most ``--show`` a bucket,
with the source line of the port that made the call), then a JSON
summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Recorder(TorchDispatchMode):
    """Keeps (op name, the first ``n`` rows of each output) of every aten
    call with an output whose leading axis is the bucket, in order."""

    def __init__(self, bucket: int, n: int) -> None:
        super().__init__()
        self.bucket, self.n = bucket, n
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        # skipped: uninitialized buffers, and views (read at creation,
        # before the writes into their base)
        skip = [("empty" in str(func)
                 or (i < len(func._schema.returns)
                     and func._schema.returns[i].alias_info is not None
                     and not func._schema.returns[i].alias_info.is_write))
                for i in range(len(outs))]
        rows = [o[:self.n].detach().clone()
                if isinstance(o, torch.Tensor) and o.ndim and o.shape[0] == self.bucket
                and not sk else None for o, sk in zip(outs, skip)]
        if any(r is not None for r in rows):
            # the port's innermost frame that made the call
            where = next((f"{f.filename.split('dgen_tpu_torch/')[-1]}:{f.lineno}"
                          for f in reversed(traceback.extract_stack(limit=12))
                          if "dgen_tpu_torch" in f.filename
                          and "row_count_probe" not in f.filename), "?")
            self.calls.append((f"{func} at {where}", rows))
        return out


def record(engine, rows: np.ndarray, bucket: int, year_idx: int = 0,
           floor: bool = True) -> list:
    """The aten calls of one bucket of ``rows`` padded to ``bucket``, and
    with ``floor`` to the engine's launch floor too
    (``serve.engine.launch_rows``)."""
    from dgen_tpu_torch.serve.engine import launch_rows, query_program

    rows = np.asarray(rows, dtype=np.int32)
    pad = (launch_rows(rows, bucket) if floor else
           np.concatenate([rows, np.full(bucket - len(rows), rows[0], np.int32)]))
    idx = torch.from_numpy(pad.astype(np.int64)).to(engine.device)
    statics = engine._static_kwargs
    with torch.no_grad(), _Recorder(len(pad), len(rows)) as rec:
        query_program(engine.sim.table, engine.sim.profiles, engine.sim.tariffs,
                      engine.sim.inputs, idx, year_idx, **statics)
    return rec.calls


def compare(calls_a: list, calls_b: list) -> list:
    """(call index in ``calls_a``, op, output index, max abs difference) of
    every output whose requested rows differ between the two runs. The
    two call lists are aligned on their op names and source lines
    (``difflib``): at one row, broadcast operands of leading size 1 are
    recorded too, and those calls have no partner."""
    import difflib

    names_a = [c[0] for c in calls_a]
    names_b = [c[0] for c in calls_b]
    found = []
    sm = difflib.SequenceMatcher(None, names_a, names_b, autojunk=False)
    for ia, ib, size in sm.get_matching_blocks():
        for k in range(size):
            op, outs_a = calls_a[ia + k]
            outs_b = calls_b[ib + k][1]
            for j, (ra, rb) in enumerate(zip(outs_a, outs_b)):
                if ra is None or rb is None or ra.shape != rb.shape:
                    continue
                # bit for bit (NaN payloads and signed zeros included)
                if (ra.dtype == rb.dtype
                        and ra.cpu().numpy().tobytes() == rb.cpu().numpy().tobytes()):
                    continue
                diff = (float((ra.double() - rb.double()).abs().nan_to_num(0.0).max())
                        if ra.dtype != torch.bool else 1.0)
                found.append((ia + k, op, j, diff))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="ercot-all-sector")
    ap.add_argument("--agents", type=int, default=1024)
    ap.add_argument("--rate-switch-frac", type=float, default=0.0)
    ap.add_argument("--rows", type=int, nargs="+", default=[5, 17, 40],
                    help="requested table rows (a bucket of b rows takes the "
                         "first min(b, len) of them)")
    ap.add_argument("--buckets", type=int, nargs="+", default=[4],
                    help="bucket sizes held against --against")
    ap.add_argument("--against", type=int, default=8)
    ap.add_argument("--no-floor", action="store_true",
                    help="launch each bucket at its own size, below the engine's "
                         "launch floor too")
    ap.add_argument("--show", type=int, default=20)
    args = ap.parse_args(argv)

    from dgen_tpu_torch import presets
    from dgen_tpu_torch.serve.engine import ServeEngine

    sim, _, _ = presets.build(args.preset, n_agents=args.agents, end_year=2016,
                              rate_switch_frac=args.rate_switch_frac, device=args.device)
    engine = ServeEngine(sim)
    summary = []
    refs = {}
    for b in args.buckets:
        rows = np.asarray(args.rows[:min(b, len(args.rows))], dtype=np.int64)
        n = len(rows)
        if n not in refs:
            refs[n] = record(engine, rows, args.against, floor=not args.no_floor)
        calls = record(engine, rows, b, floor=not args.no_floor)
        found = compare(calls, refs[n])
        for i, op, j, diff in found[:args.show]:
            print(f"bucket {b} vs {args.against} ({n} rows): call {i} {op} output "
                  f"{j}: max abs difference {diff:.6g}")
        summary.append({"bucket": b, "rows": n, "calls": len(calls),
                        "differing": len(found),
                        "first": found[0][1] if found else None})
    print(json.dumps({"against": args.against, "preset": args.preset,
                      "agents": args.agents, "buckets": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
