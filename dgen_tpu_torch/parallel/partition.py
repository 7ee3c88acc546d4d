"""State-balanced agent partitioning across ranks (port of
``dgen_tpu/parallel/partition.py``).

The reference load-balances its national run by binning states into
size classes and submitting each as a separate batch job. The port's
equivalent: order agents so that each rank's shard holds whole states,
by greedy largest-first packing of states onto ranks, then pad every
shard to one length. A state x sector group then lives whole on one
rank, so each group's reduction runs where the group lives and the
cross-rank combine adds exact zeros (``models.market.segment_sum``).

Host numpy: the partition equals the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dgen_tpu_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Partition:
    """Host-side description of an agent -> rank assignment."""

    order: np.ndarray          # [N] permutation: new position -> old index
    shard_sizes: np.ndarray    # [D] real agents per shard
    shard_len: int             # padded per-shard length
    device_of_state: np.ndarray  # [n_states] -> rank (primary shard)
    #: [D * shard_len] original table row behind each padded position (-1
    #: for per-shard padding rows); set by :func:`partition_table`, None
    #: for a partition built directly by :func:`partition_by_state`
    gather_rows: Optional[np.ndarray] = None

    @property
    def n_devices(self) -> int:
        return len(self.shard_sizes)

    @property
    def total_padded(self) -> int:
        return self.n_devices * self.shard_len


def partition_by_state(
    state_idx: np.ndarray,
    n_states: int,
    n_devices: int,
    pad_multiple: int = 8,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> Partition:
    """Greedy largest-first packing of states onto ranks.

    Returns a permutation placing each rank's agents contiguously. The
    agents of one state always land on one rank (a state bigger than a
    balanced share still goes to the currently lightest rank), and the
    order within a rank is the input order (a stable sort).

    ``mesh_shape=(H, D)`` with H > 1 packs hierarchically: states go to
    the lightest host first, then to the lightest rank of that host, so
    whole states stay host-local. The global rank is ``host * D +
    device``."""
    state_idx = np.asarray(state_idx)
    counts = np.bincount(state_idx, minlength=n_states)
    device_of_state = np.zeros(n_states, dtype=np.int32)
    if mesh_shape is not None and mesh_shape[0] > 1:
        h, d = int(mesh_shape[0]), int(mesh_shape[1])
        if h * d != n_devices:
            raise ValueError(
                f"mesh shape {h}x{d} does not cover {n_devices} devices")
        host_load = np.zeros(h, dtype=np.int64)
        dev_load = np.zeros((h, d), dtype=np.int64)
        for s in np.argsort(-counts):
            if counts[s] == 0:
                device_of_state[s] = 0
                continue
            hh = int(np.argmin(host_load))
            dd = int(np.argmin(dev_load[hh]))
            device_of_state[s] = hh * d + dd
            host_load[hh] += counts[s]
            dev_load[hh, dd] += counts[s]
    else:
        device_load = np.zeros(n_devices, dtype=np.int64)
        for s in np.argsort(-counts):
            if counts[s] == 0:
                device_of_state[s] = 0
                continue
            dd = int(np.argmin(device_load))
            device_of_state[s] = dd
            device_load[dd] += counts[s]

    agent_device = device_of_state[state_idx]
    order = np.argsort(agent_device, kind="stable")
    shard_sizes = np.bincount(agent_device, minlength=n_devices)

    shard_len = int(shard_sizes.max()) if len(state_idx) else 0
    shard_len = ((shard_len + pad_multiple - 1) // pad_multiple) * pad_multiple
    shard_len = max(shard_len, pad_multiple)
    return Partition(
        order=order,
        shard_sizes=shard_sizes,
        shard_len=shard_len,
        device_of_state=device_of_state,
    )


def apply_partition_indices(part: Partition, n_agents: int) -> Tuple[np.ndarray, np.ndarray]:
    """(gather_index [D * shard_len], valid_mask [D * shard_len]) mapping
    the padded, rank-ordered layout back to original agent rows (index 0
    on padding rows, masked out)."""
    gather = np.zeros(part.total_padded, dtype=np.int64)
    mask = np.zeros(part.total_padded, dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(part.shard_sizes)[:-1]])
    for d in range(part.n_devices):
        seg = part.order[starts[d]: starts[d] + part.shard_sizes[d]]
        off = d * part.shard_len
        gather[off: off + len(seg)] = seg
        mask[off: off + len(seg)] = 1.0
    return gather, mask


def partition_table(table, n_devices: int, pad_multiple: int = 128,
                    mesh_shape: Optional[Tuple[int, int]] = None):
    """(reordered AgentTable, Partition): the agents laid out so that each
    rank's shard holds whole states.

    The partition covers real agents only (padding rows are made anew per
    shard); every ``[N]``-leading tensor is gathered into the new order on
    its device and the mask rebuilt, so results keyed by ``agent_id`` do
    not depend on the permutation. ``gather_rows`` of the returned
    partition records the original row behind each position (-1 on
    padding). ``mesh_shape`` packs host-hierarchically
    (:func:`partition_by_state`)."""
    old_mask = table.mask.cpu().numpy() > 0
    real_rows = np.nonzero(old_mask)[0]
    state_real = table.state_idx.cpu().numpy()[real_rows]
    part = partition_by_state(
        state_real, table.n_states, n_devices, pad_multiple,
        mesh_shape=mesh_shape,
    )
    gather_sub, valid = apply_partition_indices(part, len(real_rows))
    gather = real_rows[gather_sub]
    n_old = table.n_agents
    idx = torch.from_numpy(gather).to(table.mask.device)

    def g(x):
        return x[idx] if x.ndim >= 1 and x.shape[0] == n_old else x

    out = tree_map(g, table)
    part = dataclasses.replace(part, gather_rows=np.where(valid > 0, gather, -1))
    return dataclasses.replace(
        out, mask=torch.from_numpy(valid).to(table.mask.device)), part
