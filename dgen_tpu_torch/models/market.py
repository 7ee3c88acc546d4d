"""Market step: max market share, Bass diffusion, historical anchoring
and integer storage-attachment allocation, as vectorized segment ops
over the agent axis (port of ``dgen_tpu/models/market.py``).
``jax.ops.segment_sum`` becomes :func:`segment_sum`: ``index_add_`` on
the CPU (a sum in row order), and on a card a fixed-order sum, since the
card's ``index_add_`` adds with atomics in no fixed order.

On a multi-rank run each rank holds a shard of the agent rows, and the
group reductions take the run's ``reduce`` (a
``parallel.mesh.CrossRank``). Where the partition puts every state, and
so every state x sector group, whole on one rank, each group's sum runs
where the group lives and an ``all_reduce`` adds the other ranks' exact
zeros; the within-group battery rank is local too. Where groups straddle
ranks, the ``[N]`` operands are gathered in rank order and the
single-process code runs on them. Either way every rank computes the
group values a single process computes.
"""

from __future__ import annotations

import dataclasses

import torch

from dgen_tpu_torch.config import PAYBACK_GRID_N, PAYBACK_GRID_STEP
from dgen_tpu_torch.grad.smooth import lerp_lookup


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int, reduce=None) -> torch.Tensor:
    """Sums of ``x`` rows by segment id ``idx`` into ``n`` segments.

    On the CPU ``index_add_`` adds each segment's rows in row order. On a
    card ``index_add_`` adds with atomics in no fixed order, so two runs
    could round a group's sum differently, and a battery unit
    (``allocate_battery_adopters`` rounds a group's sum) or an anchored
    share move between them. There a ``[N]`` ``x`` is summed in a fixed
    order instead (:func:`_fixed_order_segment_sum`), which the zero rows
    (padding, filler, masked agents) do not enter, so it is the same
    whatever rows pad the table. A ``[N, ...]`` ``x`` (the state-hourly
    aggregate) keeps ``index_add_``.

    ``reduce`` (a multi-rank run's ``parallel.mesh.CrossRank``): the sums
    over every rank's rows. With whole groups on each rank the local sums
    are combined by an ``all_reduce`` that adds exact zeros, the card's
    fixed-order sum laid out at the widest rank's width (a row's sum
    depends on the matrix's width, so every rank and a single process sum
    a group at one width); with straddling groups ``x`` and ``idx`` are
    gathered and summed whole."""
    if reduce is not None and not reduce.whole_groups:
        return segment_sum(reduce.gather(x), reduce.gather(idx), n)
    if x.device.type == "cuda" and x.dim() == 1 and x.is_floating_point():
        out = _fixed_order_segment_sum(x, idx, n, reduce)
    else:
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out.index_add_(0, idx.long(), x)
    return out if reduce is None else reduce.combine(out)


def _fixed_order_segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int,
                             reduce=None) -> torch.Tensor:
    """[n] sums of a ``[N]`` ``x`` by segment, in a fixed order on the
    card: each segment's nonzero values, in row order, laid out as one
    row of an ``[n, L]`` zero-filled matrix (L: the largest segment's
    count of nonzero values), summed along the rows. The zero values go to
    a spare segment, so the matrix, and the sums, depend only on each
    segment's nonzero values and their order. ``reduce``: the width is the
    widest rank's, so a group sums at the width a single process sums it
    at."""
    seg = torch.where(x != 0, idx.long(), torch.full_like(idx, n, dtype=torch.long))
    seg_sorted, order = torch.sort(seg, stable=True)
    counts = torch.bincount(seg_sorted, minlength=n + 1)
    width = int(counts[:n].max()) if n else 0
    if reduce is not None:
        width = reduce.topo.max_int(width)
    if width == 0:
        return torch.zeros(n, dtype=x.dtype, device=x.device)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(seg.shape[0], device=x.device) - starts[seg_sorted]
    real = seg_sorted < n
    dense = torch.zeros((n, width), dtype=x.dtype, device=x.device)
    dense[seg_sorted[real], pos[real]] = x[order[real]]
    return dense.sum(dim=1)


def max_market_share(payback_period: torch.Tensor, sector_idx: torch.Tensor,
                     mms_table: torch.Tensor, interp: bool = False) -> torch.Tensor:
    """Max market share from the payback curve tabulated on the 0.1-year
    grid (``mms_table`` [n_sectors, PAYBACK_GRID_N]).

    ``interp=True`` (the differentiable twin) interpolates linearly
    between the two bracketing grid entries in place of the snap to the
    nearest: the gradient in payback is the table's local slope, and the
    gradient in the table spreads over both entries (what the
    calibration's elasticity rides)."""
    if interp:
        return lerp_lookup(mms_table[sector_idx.long()],
                           payback_period / PAYBACK_GRID_STEP)
    idx = torch.clamp(
        torch.round(payback_period / PAYBACK_GRID_STEP).to(torch.int64),
        0, PAYBACK_GRID_N - 1,
    )
    return mms_table[sector_idx.long(), idx]


@dataclasses.dataclass(frozen=True)
class MarketState:
    """Cross-year carry per agent, leaves ``[N]``."""

    market_share: torch.Tensor
    max_market_share: torch.Tensor
    adopters_cum: torch.Tensor
    market_value: torch.Tensor
    system_kw_cum: torch.Tensor
    batt_kw_cum: torch.Tensor
    batt_kwh_cum: torch.Tensor
    initial_adopters: torch.Tensor
    initial_market_share: torch.Tensor

    @staticmethod
    def zeros(n: int, device) -> "MarketState":
        return MarketState(*(
            torch.zeros(n, dtype=torch.float32, device=device)
            for _ in dataclasses.fields(MarketState)
        ))


@dataclasses.dataclass(frozen=True)
class DiffusionOutputs:
    """Per-agent per-year adoption results."""

    market_share: torch.Tensor
    new_market_share: torch.Tensor
    new_adopters: torch.Tensor
    new_system_kw: torch.Tensor
    new_market_value: torch.Tensor
    number_of_adopters: torch.Tensor
    system_kw_cum: torch.Tensor
    market_value: torch.Tensor


def bass_new_adopt_fraction(p, q, teq2):
    """Cumulative Bass adoption fraction at equivalent time ``teq2``."""
    f = torch.exp(-(p + q) * teq2)
    return (1.0 - f) / (1.0 + (q / p) * f)


def equivalent_time(market_share_last_year, mms, p, q):
    """Invert the Bass curve to find where last year's share sits."""
    mms_fz = torch.where(mms == 0.0, 1e-9, mms)
    ratio = torch.where(market_share_last_year > mms_fz, 0.0,
                        market_share_last_year / mms_fz)
    return torch.log((1.0 - ratio) / (1.0 + ratio * (q / p))) / (-(p + q))


def _bass_floored_share(market_share_last, mms, bass_p, bass_q, teq_yr1,
                        is_first_year: bool, year_step: float):
    """Invert to equivalent time, step forward, take the new cumulative
    share, floored at last year's."""
    teq = equivalent_time(market_share_last, mms, bass_p, bass_q)
    teq2 = teq + (teq_yr1 if is_first_year else year_step)
    bass_ms = mms * bass_new_adopt_fraction(bass_p, bass_q, teq2)
    return torch.maximum(market_share_last, bass_ms)


def diffusion_step(
    state: MarketState,
    mms: torch.Tensor,
    system_kw: torch.Tensor,
    system_capex_per_kw: torch.Tensor,
    developable_agent_weight: torch.Tensor,
    bass_p: torch.Tensor,
    bass_q: torch.Tensor,
    teq_yr1: torch.Tensor,
    is_first_year: bool,
    year_step: float = 2.0,
) -> DiffusionOutputs:
    """One Bass-diffusion solve."""
    msly = state.market_share
    market_share = _bass_floored_share(
        msly, mms, bass_p, bass_q, teq_yr1, is_first_year, year_step)
    new_ms = market_share - msly
    # zero the step where share already exceeds the max market share
    new_ms = torch.where(market_share > mms, 0.0, new_ms)

    new_adopters = new_ms * developable_agent_weight
    new_system_kw = new_adopters * system_kw
    new_market_value = new_adopters * system_kw * system_capex_per_kw

    return DiffusionOutputs(
        market_share=market_share,
        new_market_share=new_ms,
        new_adopters=new_adopters,
        new_system_kw=new_system_kw,
        new_market_value=new_market_value,
        number_of_adopters=state.adopters_cum + new_adopters,
        system_kw_cum=state.system_kw_cum + new_system_kw,
        market_value=state.market_value + new_market_value,
    )


def diffusion_step_tech_choice(
    market_share_last: torch.Tensor,      # [N, T]
    adopters_cum_last: torch.Tensor,      # [N, T]
    capacity_cum_last: torch.Tensor,      # [N, T]
    market_value_last: torch.Tensor,      # [N, T]
    selected: torch.Tensor,               # [N, T] 1.0 for the chosen tech
    mms: torch.Tensor,                    # [N, T]
    system_kw: torch.Tensor,              # [N, T]
    system_capex_per_kw: torch.Tensor,    # [N, T]
    developable_agent_weight: torch.Tensor,  # [N]
    bass_p: torch.Tensor,                 # [N, T]
    bass_q: torch.Tensor,                 # [N, T]
    teq_yr1: torch.Tensor,                # [N, T]
    is_first_year: bool,
    year_step: float = 2.0,
) -> dict:
    """The reference's multi-technology diffusion solve (the tech-choice
    path its solar driver no longer calls): one row per candidate
    technology, ``selected`` marking this year's choice. The Bass share
    is floored at last year's; unselected techs hold their share; the
    selected tech is capped at ``1 - sum(unselected shares)``; the step
    is zeroed where share exceeds the max market share; flows are gated
    on a nonzero system size and accumulated onto last year's. Returns
    the ``[N, T]`` outputs, carry fields included."""
    sel = selected.to(market_share_last.dtype)
    diffusion_ms = _bass_floored_share(
        market_share_last, mms, bass_p, bass_q, teq_yr1, is_first_year, year_step)
    diffusion_ms = diffusion_ms * sel
    market_share = torch.maximum(diffusion_ms, market_share_last)

    # cap the selected tech at 1 - (sum of unselected shares) per agent
    unselected_sum = (market_share * (1.0 - sel)).sum(dim=1, keepdim=True)
    cap = 1.0 - unselected_sum
    market_share = torch.where(sel > 0, torch.minimum(market_share, cap), market_share)

    new_ms = market_share - market_share_last
    new_ms = torch.where(market_share > mms, 0.0, new_ms)

    w = developable_agent_weight[:, None]
    new_adopters = torch.where(system_kw == 0.0, 0.0, new_ms * w)
    new_capacity = new_adopters * system_kw
    new_value = new_adopters * system_kw * system_capex_per_kw

    return {
        "market_share": market_share,
        "new_market_share": new_ms,
        "new_adopters": new_adopters,
        "new_capacity_kw": new_capacity,
        "new_market_value": new_value,
        "number_of_adopters": adopters_cum_last + new_adopters,
        "installed_capacity_kw": capacity_cum_last + new_capacity,
        "market_value": market_value_last + new_value,
    }


def anchor_to_observed(system_kw_cum, group_idx, observed_group_kw, sector_is_res,
                       developable_agent_weight, n_groups: int, reduce=None):
    """Rescale modeled cumulative PV to observed deployment in anchor
    years: (system_kw_cum, number_of_adopters, market_share), with the
    5 kW res / 100 kW non-res per-system heuristic for adopter counts.
    ``reduce``: the group sums over every rank (:func:`segment_sum`)."""
    g = group_idx.long()
    group_kw = segment_sum(system_kw_cum, g, n_groups, reduce)
    # only developable agents carry anchored capacity
    countable = (developable_agent_weight > 0.0).to(system_kw_cum.dtype)
    group_count = segment_sum(countable, g, n_groups, reduce)
    per_agent_group_kw = group_kw[g]
    per_agent_count = torch.clamp_min(group_count[g], 1.0)
    scale = torch.where(
        per_agent_group_kw == 0.0,
        countable / per_agent_count,
        system_kw_cum / torch.clamp_min(per_agent_group_kw, 1e-30),
    )
    anchored_kw = scale * observed_group_kw[g]
    adopters = torch.where(sector_is_res, anchored_kw / 5.0, anchored_kw / 100.0)
    share = torch.where(
        developable_agent_weight == 0.0,
        0.0,
        adopters / torch.clamp_min(developable_agent_weight, 1e-30),
    )
    return anchored_kw, adopters, share


def allocate_battery_adopters(new_adopters, group_idx, attachment_rate,
                              agent_order_key, n_groups: int, reduce=None) -> torch.Tensor:
    """Largest-remainders integer allocation of battery adopters within
    each state x sector group: agents ordered by (group asc, fraction
    desc, id asc) win the group's remaining units in rank order.

    ``reduce``: a multi-rank run's rows. With whole groups on each rank
    the group sums are combined across ranks and the order within a
    group is this rank's own (the ids order the agents totally, so the
    group's local order is its global order). With straddling groups the
    operands are gathered, the whole allocation runs on every rank, and
    each keeps its rows."""
    if reduce is not None and not reduce.whole_groups:
        full = allocate_battery_adopters(
            reduce.gather(new_adopters), reduce.gather(group_idx), attachment_rate,
            reduce.gather(agent_order_key), n_groups)
        return reduce.local(full)
    n = new_adopters.shape[0]
    g = group_idx.long()
    r = torch.clamp(attachment_rate, 0.0, 1.0)[g]

    f = r * torch.clamp_min(new_adopters, 0.0)
    base = torch.floor(f)
    frac = f - base

    group_target = torch.round(segment_sum(f, g, n_groups, reduce))
    group_base = segment_sum(base, g, n_groups, reduce)
    remainder = torch.clamp_min(group_target - group_base, 0.0)

    # lexsort (id, -frac, group): stable sorts, least significant key first
    order = torch.sort(agent_order_key, stable=True).indices
    order = order[torch.sort(-frac[order], stable=True).indices]
    order = order[torch.sort(g[order], stable=True).indices]
    sorted_group = g[order]
    # rank within group: position minus the group's first position
    pos = torch.arange(n, device=new_adopters.device)
    group_start = torch.full((n_groups,), n, dtype=pos.dtype, device=pos.device)
    group_start = group_start.scatter_reduce(0, sorted_group, pos, reduce="amin")
    rank_in_group = pos - group_start[sorted_group]
    wins_sorted = (rank_in_group < remainder[sorted_group]).to(torch.float32)
    wins = torch.zeros(n, dtype=torch.float32, device=new_adopters.device)
    wins[order] = wins_sorted
    return base + wins


def initial_market_shares(starting_group_kw, starting_group_batt_kw,
                          starting_group_batt_kwh, group_idx,
                          developable_agent_weight, system_kw,
                          n_groups: int, reduce=None) -> MarketState:
    """Apportion state x sector starting capacity to agents by
    developable weight (``reduce``: the group weights over every rank)."""
    g = group_idx.long()
    group_weight = segment_sum(developable_agent_weight, g, n_groups, reduce)
    w_frac = developable_agent_weight / torch.clamp_min(group_weight[g], 1e-30)

    kw_cum = w_frac * starting_group_kw[g]
    batt_kw_cum = w_frac * starting_group_batt_kw[g]
    batt_kwh_cum = w_frac * starting_group_batt_kwh[g]
    adopters = kw_cum / torch.clamp_min(system_kw, 1e-9)
    share = torch.where(
        developable_agent_weight == 0.0,
        0.0,
        torch.clamp(adopters / torch.clamp_min(developable_agent_weight, 1e-30), 0.0, 1.0),
    )
    return MarketState(
        market_share=share,
        max_market_share=share,
        adopters_cum=adopters,
        market_value=torch.zeros_like(share),
        system_kw_cum=kw_cum,
        batt_kw_cum=batt_kw_cum,
        batt_kwh_cum=batt_kwh_cum,
        initial_adopters=adopters,
        initial_market_share=share,
    )
