"""Tariff-corpus clustering: shared rate banks at tight pad widths (port
of ``dgen_tpu/ops/tariffcluster.py``).

``compile_tariffs`` (ops.tariff) pads every tariff to the corpus-wide
``max_periods`` / ``max_tiers``, so one 2-period tariff makes every
flat-rate agent pay for ``12 * max_periods`` bucket lanes in the
bucket-sums kernel, and one 2-tier tariff the tier clip. Real corpora
collapse to a handful of structural shapes:

* :func:`analyze_bank` splits a compiled ``TariffBank`` into K structural
  clusters keyed by ``(metering mode, true period count, true tier
  count, demand-charge presence)``. Every member of a cluster has the
  same tight extents, so the cluster's shared rate bank is sliced at its
  own widths, and byte-identical rows are deduplicated onto one bank row.
* :func:`plan_layout` computes the cluster-major agent permutation:
  within each device shard the real rows are stably reordered cluster
  by cluster and each per-(device, cluster) segment is padded to a
  uniform length with masked filler rows, so results keyed by
  ``agent_id`` are unchanged.

The analysis and the layout are host numpy and equal the JAX package's
exactly; the compact banks are the port's :class:`TariffBank` on the
device of the bank they came from. The compute half is
``models.simulation``: sizing runs once per cluster at the cluster's
``n_periods`` and with the cluster's ``net_billing`` flag (a net-metered
cluster whose NEM gate never closes prices by the linear identity).

CLI: ``python -m dgen_tpu_torch.ops.tariffcluster --report`` prints the
cluster histogram and the modeled lane savings of a package or a
synthetic national world (host numpy: the containers are built on the
CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dgen_tpu_torch.ops.tariff import NET_BILLING, TariffBank


class ClusterSpec(NamedTuple):
    """The signature of one cluster and its segment of the layout."""

    metering: int     # NET_METERING | NET_BILLING
    n_periods: int    # true TOU period count (tight pad width)
    n_tiers: int      # true tier count (tight pad width)
    has_demand: bool  # always False today (demand charges are skipped)
    n_rates: int      # deduplicated rate rows in the shared bank
    seg_len: int      # per-device rows of this cluster's segment
    offset: int       # per-device row offset of the segment
    #: the cluster's net-billing flag: False sizes the whole cluster by
    #: the linear-NEM identity (run_static_flags applied to the cluster)
    net_billing: bool


class ClusterLayout(NamedTuple):
    """A cluster-major agent layout. The compact banks and the per-row
    local tariff indices travel separately."""

    clusters: Tuple[ClusterSpec, ...]
    n_dev: int
    local_len: int    # per-device rows = sum of segment lengths

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    @property
    def n_rows(self) -> int:
        return self.n_dev * self.local_len

    def with_flags(self, flags: Tuple[bool, ...]) -> "ClusterLayout":
        """The layout with the per-cluster net-billing flags replaced
        (after the host proves them against a set of scenario inputs)."""
        if len(flags) != self.n_clusters:
            raise ValueError(
                f"{len(flags)} flags for {self.n_clusters} clusters")
        return self._replace(clusters=tuple(
            c._replace(net_billing=bool(f))
            for c, f in zip(self.clusters, flags)))

    def pin_net_billing(self, net_billing: bool) -> "ClusterLayout":
        """Every cluster pinned to one flag (True is exact for every
        cluster; it only skips the linear shortcut)."""
        return self.with_flags((bool(net_billing),) * self.n_clusters)

    def cluster_of_rows(self) -> np.ndarray:
        """[n_dev * local_len] int32: the cluster of each laid-out row."""
        per_dev = np.empty(self.local_len, dtype=np.int32)
        for ci, c in enumerate(self.clusters):
            per_dev[c.offset:c.offset + c.seg_len] = ci
        return np.tile(per_dev, self.n_dev)


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Host-side corpus analysis: global tariff index -> (cluster, local
    row of the cluster's shared compact bank)."""

    keys: Tuple[Tuple[int, int, int, bool], ...]
    members: Tuple[Tuple[int, ...], ...]   # global tariff ids per cluster
    banks: Tuple[TariffBank, ...]          # compact, deduplicated banks
    cluster_of_tariff: np.ndarray          # [K_global] int32
    local_of_tariff: np.ndarray            # [K_global] int32

    @property
    def n_clusters(self) -> int:
        return len(self.keys)


def analyze_bank(tariffs: TariffBank) -> ClusterPlan:
    """Split a compiled bank into structural clusters.

    Two tariffs share a cluster iff they share ``(metering, n_periods,
    n_tiers, has_demand)``, so every member's tight slice has the same
    shape. Within a cluster, tariffs whose tight price, caps, sell
    prices, schedule and fixed charge are the same bytes share one bank
    row. The compact banks are placed on the device of ``tariffs``."""
    h = lambda t: t.cpu().numpy()
    met = h(tariffs.metering)
    n_p = h(tariffs.n_periods)
    n_t = h(tariffs.n_tiers)
    price = h(tariffs.price)
    tier_cap = h(tariffs.tier_cap)
    sell = h(tariffs.sell_price)
    sched = h(tariffs.hour_period)
    fixed = h(tariffs.fixed_monthly)

    K = tariffs.n_tariffs
    keys: list = []
    key_of: Dict[Tuple[int, int, int, bool], int] = {}
    members: list = []
    dedup: list = []        # per cluster: canonical bytes -> local row
    rows: list = []         # per cluster: global source rows
    cluster_of = np.zeros(K, dtype=np.int32)
    local_of = np.zeros(K, dtype=np.int32)

    for k in range(K):
        P, T = int(n_p[k]), int(n_t[k])
        key = (int(met[k]), P, T, False)
        ci = key_of.get(key)
        if ci is None:
            ci = len(keys)
            key_of[key] = ci
            keys.append(key)
            members.append([])
            dedup.append({})
            rows.append([])
        canon = b"".join((
            np.ascontiguousarray(price[k, :P, :T]).tobytes(),
            np.ascontiguousarray(tier_cap[k, :T]).tobytes(),
            np.ascontiguousarray(sell[k, :P]).tobytes(),
            np.ascontiguousarray(sched[k]).tobytes(),
            np.float32(fixed[k]).tobytes(),
        ))
        li = dedup[ci].get(canon)
        if li is None:
            li = len(rows[ci])
            dedup[ci][canon] = li
            rows[ci].append(k)
        members[ci].append(k)
        cluster_of[k] = ci
        local_of[k] = li

    dev = tariffs.price.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    banks = []
    for (m, P, T, _), src in zip(keys, rows):
        src = np.asarray(src, dtype=np.int64)
        banks.append(TariffBank(
            price=t(price[src][:, :P, :T]),
            tier_cap=t(tier_cap[src][:, :T]),
            sell_price=t(sell[src][:, :P]),
            hour_period=t(sched[src]),
            fixed_monthly=t(fixed[src]),
            metering=t(met[src]),
            n_periods=t(n_p[src]),
            n_tiers=t(n_t[src]),
        ))
    return ClusterPlan(
        keys=tuple(tuple(k) for k in keys),
        members=tuple(tuple(m) for m in members),
        banks=tuple(banks),
        cluster_of_tariff=cluster_of,
        local_of_tariff=local_of,
    )


def plan_layout(
    plan: ClusterPlan,
    tariff_idx: np.ndarray,
    mask: np.ndarray,
    n_dev: int,
    pad_mult: int,
) -> Tuple[ClusterLayout, np.ndarray, np.ndarray, np.ndarray]:
    """Cluster-major layout of a table of ``n_dev`` equal device shards.

    Within each shard the real rows (``mask > 0``) are stably reordered
    by cluster id, keeping their order within a cluster, and each
    per-(device, cluster) segment is padded to a device-uniform,
    ``pad_mult``-rounded length. A padding slot gathers a real row of its
    segment (or of its shard) with valid 0.

    Returns ``(layout, gather, valid, cluster_tidx)``: ``gather`` [N']
    int64, new position -> source row (its inverse is
    :func:`original_positions`); ``valid`` [N'] float32, 1 for real rows;
    ``cluster_tidx`` [N'] int32, each row's index into its cluster's bank
    (0 on padding slots). Only clusters with a real row appear, in plan
    order."""
    tariff_idx = np.asarray(tariff_idx)
    mask = np.asarray(mask)
    N = len(tariff_idx)
    if n_dev < 1 or N % n_dev:
        raise ValueError(f"{N} rows not divisible into {n_dev} shards")
    local = N // n_dev
    cid = plan.cluster_of_tariff[tariff_idx]
    real = mask > 0

    # per-device stable grouping by cluster id
    seg_rows = [[None] * plan.n_clusters for _ in range(n_dev)]
    counts = np.zeros((n_dev, plan.n_clusters), dtype=np.int64)
    for d in range(n_dev):
        sl = slice(d * local, (d + 1) * local)
        rows_d = np.nonzero(real[sl])[0] + d * local
        cid_d = cid[rows_d]
        for ci in range(plan.n_clusters):
            seg = rows_d[cid_d == ci]
            seg_rows[d][ci] = seg
            counts[d, ci] = len(seg)

    kept = [ci for ci in range(plan.n_clusters) if counts[:, ci].max() > 0]
    specs = []
    off = 0
    for ci in kept:
        need = int(counts[:, ci].max())
        seg_len = max(-(-need // pad_mult) * pad_mult, pad_mult)
        m, P, T, hd = plan.keys[ci]
        specs.append(ClusterSpec(
            metering=m, n_periods=P, n_tiers=T, has_demand=hd,
            n_rates=plan.banks[ci].n_tariffs, seg_len=seg_len,
            offset=off, net_billing=m == NET_BILLING,
        ))
        off += seg_len
    local_len = off

    gather = np.zeros(n_dev * local_len, dtype=np.int64)
    valid = np.zeros(n_dev * local_len, dtype=np.float32)
    for d in range(n_dev):
        # filler stays in its shard: a real row of the segment's own
        # cluster where there is one (the mask zeroes its contribution)
        shard_real = np.nonzero(real[d * local:(d + 1) * local])[0]
        shard_fill = (shard_real[0] + d * local) if len(shard_real) \
            else d * local
        for spec, ci in zip(specs, kept):
            seg = seg_rows[d][ci]
            fill = seg[0] if len(seg) else shard_fill
            o = d * local_len + spec.offset
            gather[o:o + len(seg)] = seg
            gather[o + len(seg):o + spec.seg_len] = fill
            valid[o:o + len(seg)] = 1.0

    cluster_tidx = plan.local_of_tariff[tariff_idx[gather]].astype(np.int32)
    # a filler gathered from another cluster (an empty segment on this
    # device) would index outside the segment's bank: clamp it to row 0
    gathered_cid = cid[gather]
    layout = ClusterLayout(clusters=tuple(specs), n_dev=n_dev,
                           local_len=local_len)
    own_cid = np.asarray(
        [kept[c] for c in layout.cluster_of_rows()], dtype=np.int64)
    cluster_tidx = np.where(gathered_cid == own_cid, cluster_tidx, 0)
    return layout, gather, valid, cluster_tidx


def banks_for_layout(
    plan: ClusterPlan, layout: ClusterLayout
) -> Tuple[TariffBank, ...]:
    """The layout's compact banks in layout cluster order (the layout's
    clusters are a plan-ordered subset of the plan's, matched by their
    structural key)."""
    by_key = {k: b for k, b in zip(plan.keys, plan.banks)}
    return tuple(
        by_key[(c.metering, c.n_periods, c.n_tiers, c.has_demand)]
        for c in layout.clusters
    )


def original_positions(gather: np.ndarray, valid: np.ndarray,
                       n_original: int) -> np.ndarray:
    """[n_original] int64: the laid-out position of each source row (-1
    for a dropped, masked source row). Gathering a laid-out result at
    these positions restores source order bit for bit."""
    pos = np.full(n_original, -1, dtype=np.int64)
    idx = np.nonzero(np.asarray(valid) > 0)[0]
    pos[np.asarray(gather)[idx]] = idx
    return pos


# ---------------------------------------------------------------------------
# Reporting: cluster histogram + modeled lane-op savings
# ---------------------------------------------------------------------------

def cluster_report(
    tariffs: TariffBank,
    tariff_idx: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
) -> dict:
    """Cluster histogram and modeled bucket-lane savings.

    The bucket-sums kernel's lane work an agent scales with its bucket
    axis, ``12 * n_periods``; linear (NEM) clusters run no kernel lanes.
    The model compares ``sum_c agents_c * 12 * P_c`` (net-billing
    clusters at tight widths) with every agent paying ``12 *
    max_periods`` in one corpus-wide kernel, the unclustered cost
    whenever the corpus has a net-billing tariff. NEM clusters count as
    linear (their gate proof depends on the scenario)."""
    plan = analyze_bank(tariffs)
    if tariff_idx is None:
        agents_of = {
            ci: len(m) for ci, m in enumerate(plan.members)}
        n_agents = tariffs.n_tariffs
    else:
        tariff_idx = np.asarray(tariff_idx)
        if mask is not None:
            tariff_idx = tariff_idx[np.asarray(mask) > 0]
        cnt = np.bincount(plan.cluster_of_tariff[tariff_idx],
                          minlength=plan.n_clusters)
        agents_of = {ci: int(cnt[ci]) for ci in range(plan.n_clusters)}
        n_agents = int(tariff_idx.shape[0])

    clusters = []
    lanes_clustered = 0
    for ci, (m, P, T, hd) in enumerate(plan.keys):
        nb = m == NET_BILLING
        lanes = agents_of[ci] * 12 * P if nb else 0
        lanes_clustered += lanes
        clusters.append({
            "metering": int(m),
            "n_periods": int(P),
            "n_tiers": int(T),
            "has_demand": bool(hd),
            "n_tariffs": len(plan.members[ci]),
            "n_rates": plan.banks[ci].n_tariffs,
            "n_agents": agents_of[ci],
            "net_billing": nb,
            "bucket_lanes": lanes,
        })
    any_nb = any(c["net_billing"] for c in clusters)
    lanes_global = n_agents * 12 * tariffs.max_periods if any_nb else 0
    return {
        "n_tariffs": tariffs.n_tariffs,
        "n_clusters": plan.n_clusters,
        "n_agents": n_agents,
        "global_pad": {"n_periods": tariffs.max_periods,
                       "n_tiers": tariffs.max_tiers},
        "clusters": clusters,
        "bucket_lanes_global": int(lanes_global),
        "bucket_lanes_clustered": int(lanes_clustered),
        "modeled_lane_savings": round(
            1.0 - lanes_clustered / lanes_global, 4) if lanes_global else 0.0,
    }


def main(argv=None) -> int:
    """``python -m dgen_tpu_torch.ops.tariffcluster --report``: the
    cluster histogram of a saved agent package or a synthetic national
    world."""
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.ops.tariffcluster",
        description="tariff-corpus cluster histogram + modeled lane-op "
                    "savings",
    )
    p.add_argument("--report", action="store_true", required=True,
                   help="print the cluster report as JSON")
    p.add_argument("--package", default="",
                   help="agent package dir (io.package); default: a "
                        "synthetic world")
    p.add_argument("--agents", type=int, default=4096,
                   help="synthetic world size (ignored with --package)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tariff-mix", default="mixed",
                   help="synthetic corpus selector (models.synth)")
    args = p.parse_args(argv)

    if args.package:
        from dgen_tpu_torch.io.package import load_population

        pop = load_population(args.package, device="cpu")
        src = {"package": args.package}
    else:
        from dgen_tpu_torch.models.synth import NationalSpec, generate_world

        pop = generate_world(NationalSpec(
            n_agents=args.agents, seed=args.seed,
            tariff_mix=args.tariff_mix), device="cpu")
        src = {"synthetic": {"agents": args.agents, "seed": args.seed,
                             "tariff_mix": args.tariff_mix}}
    report = cluster_report(
        pop.tariffs, pop.table.tariff_idx.cpu().numpy(),
        pop.table.mask.cpu().numpy())
    report["source"] = src
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
