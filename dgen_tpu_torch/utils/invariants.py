"""Invariant harness over the port's containers (port of
``dgen_tpu/utils/invariants.py``), the analogue of the reference's
runtime dataframe tests: after each year step the leaf set, the leaf
shapes and dtypes are unchanged, and no float leaf holds a non-finite
value (with an allowlist of path substrings).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from dgen_tpu_torch.tree import leaf_paths


class InvariantViolation(AssertionError):
    pass


def check_transform(before, after, context: str = "") -> None:
    """Raise :class:`InvariantViolation` unless ``after`` has the leaf
    set, shapes and dtypes of ``before``."""
    b = leaf_paths(before)
    a = leaf_paths(after)
    missing = set(b) - set(a)
    added = set(a) - set(b)
    if missing or added:
        raise InvariantViolation(
            f"{context}: leaf set changed (missing={sorted(missing)}, "
            f"added={sorted(added)})"
        )
    for path, leaf_b in b.items():
        leaf_a = a[path]
        if leaf_b.shape != leaf_a.shape:
            raise InvariantViolation(
                f"{context}: shape of {path} changed {tuple(leaf_b.shape)} -> "
                f"{tuple(leaf_a.shape)}"
            )
        if leaf_b.dtype != leaf_a.dtype:
            raise InvariantViolation(
                f"{context}: dtype of {path} changed {leaf_b.dtype} -> {leaf_a.dtype}"
            )


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.numpy()
    return np.asarray(arr)


def nonfinite_rows(arr, k: int = 8) -> np.ndarray:
    """The first ``k`` leading-axis (agent) indices holding a non-finite
    value."""
    a = _host(arr)
    if a.ndim == 0:
        return np.asarray([0] if not np.isfinite(a) else [], dtype=np.int64)
    bad = ~np.isfinite(a.reshape(a.shape[0], -1)).all(axis=1)
    return np.flatnonzero(bad)[:k]


def check_finite(tree, allow_nonfinite: Optional[Iterable[str]] = None,
                 context: str = "", top_k: int = 8) -> None:
    """Raise :class:`InvariantViolation` if a float leaf (path not
    matching ``allow_nonfinite``) holds a non-finite value, naming the
    first ``top_k`` offending agent rows. Fetches to the host."""
    allow = tuple(allow_nonfinite or ())
    for path, leaf in leaf_paths(tree).items():
        if any(s in path for s in allow) or not leaf.is_floating_point():
            continue
        arr = _host(leaf)
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            rows = nonfinite_rows(arr, k=top_k).tolist()
            raise InvariantViolation(
                f"{context}: {n_bad} non-finite values in {path} "
                f"(first offending agent rows: {rows})"
            )
