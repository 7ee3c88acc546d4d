"""Map a function over the tensors of the port's containers.

The containers are frozen dataclasses and NamedTuples with tensor
leaves (the JAX package registers the same classes as pytrees); this is
the one traversal the port needs: moving a container to a device,
repeating or selecting every leaf of a batch, naming every leaf (of a
checkpoint, say).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_map(fn, obj, *rest):
    """``fn`` applied leaf-wise to the tensors of ``obj`` (and of the
    same-shaped ``rest``); ``None`` and non-tensor fields (static ints
    such as ``AgentTable.n_states``) pass through from ``obj``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *rest)
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        vals = {
            f.name: tree_map(fn, getattr(obj, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(obj)
        }
        return type(obj)(**vals)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(
            tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(obj)
        ))
    return obj


def to_device(obj, device: torch.device):
    """``obj`` with every tensor moved to ``device`` (no copy when a
    tensor is already there)."""
    return tree_map(lambda t: t.to(device), obj)


def leaf_paths(obj, prefix: str = "") -> dict:
    """``{path: leaf}`` of every tensor (or numpy array, as in a container
    fetched to the host) leaf of ``obj``, the path in attribute form
    (``".market.market_share"``)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = list(zip(obj._fields, obj))
    else:
        return {}
    out = {}
    for name, v in items:
        out.update(leaf_paths(v, f"{prefix}.{name}"))
    return out
