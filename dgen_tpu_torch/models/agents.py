"""The columnar agent table and the shared 8760-hour profile banks
(port of ``dgen_tpu/models/agents.py``).

A population is a frozen struct of tensors with a leading agent axis N,
padded (``mask``) to a multiple the caller picks. Ragged reference
structures are indices into shared banks: ``tariff_idx`` into a
TariffBank, ``load_idx`` / ``cf_idx`` into a :class:`ProfileBank`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dgen_tpu_torch.config import SECTORS, resolve_device
from dgen_tpu_torch.ops.cashflow import IncentiveParams
from dgen_tpu_torch.resilience.faults import corrupt_point, corrupt_rows


@dataclasses.dataclass(frozen=True)
class AgentTable:
    """Static per-agent attributes, every tensor ``[N]`` (incentive
    leaves ``[N, 2]``)."""

    agent_id: torch.Tensor        # int32
    mask: torch.Tensor            # float32, 1 = real agent, 0 = padding
    state_idx: torch.Tensor       # int32
    sector_idx: torch.Tensor      # int32 (0 res, 1 com, 2 ind)
    group_idx: torch.Tensor       # int32 = state_idx * n_sectors + sector_idx
    region_idx: torch.Tensor      # int32
    tariff_idx: torch.Tensor      # int32 into TariffBank
    #: post-adoption DG rate; equals tariff_idx when no switch applies
    tariff_switch_idx: torch.Tensor
    load_idx: torch.Tensor        # int32 into ProfileBank.load
    cf_idx: torch.Tensor          # int32 into ProfileBank.solar_cf
    customers_in_bin: torch.Tensor
    load_kwh_per_customer_in_bin: torch.Tensor
    developable_frac: torch.Tensor
    #: one-time interconnection charge, paid only when the switch applies
    one_time_charge: torch.Tensor
    #: NEM availability: system-kW limit (0 = no NEM) and policy window
    nem_kw_limit: torch.Tensor
    nem_first_year: torch.Tensor
    nem_sunset_year: torch.Tensor
    #: DG-rate switch window [switch_min_kw, switch_max_kw) on sized kW
    switch_min_kw: torch.Tensor
    switch_max_kw: torch.Tensor
    incentives: IncentiveParams
    n_states: int = 51

    @property
    def n_agents(self) -> int:
        return self.agent_id.shape[0]

    @property
    def n_sectors(self) -> int:
        return len(SECTORS)

    @property
    def n_groups(self) -> int:
        return self.n_states * self.n_sectors

    def developable_agent_weight(self, customers: torch.Tensor) -> torch.Tensor:
        return self.developable_frac * customers * self.mask


@dataclasses.dataclass(frozen=True)
class ProfileBank:
    """Shared 8760-hour profile banks: float32, bfloat16
    (``RunConfig.bf16_banks``) or, for load and solar_cf, int8 codes
    (``RunConfig.quant_banks``)."""

    load: torch.Tensor       # [L, 8760] normalized to sum 1.0
    solar_cf: torch.Tensor   # [S, 8760] kWh per kW_dc per hour
    wholesale: torch.Tensor  # [R, 8760] $/kWh wholesale price by region
    #: int8 banks: per-row float32 dequantization factors of ``load`` /
    #: ``solar_cf`` (value = scale[row] * code); None = not quantized. The
    #: wholesale (sell) stream is never quantized.
    load_scale: Optional[torch.Tensor] = None
    solar_cf_scale: Optional[torch.Tensor] = None

    @property
    def hours(self) -> int:
        return self.load.shape[1]


def quantize_rows(bank) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization of a [R, 8760] profile bank:
    ``codes = rint(x / scale)`` with ``scale = rowmax(|x|) / 127``
    (all-zero rows get scale 1.0, so they dequantize to exact zeros).
    Exact zeros stay exact zeros, so the daylight layout's premise (gen
    == 0 off-daylight) survives quantization."""
    x = np.asarray(bank, np.float32)
    amax = np.max(np.abs(x), axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


#: padding fills that keep masked rows inert: no NEM cap pressure, the
#: switch window never entered, sunset far in the future
_PAD_FILLS = {
    "nem_kw_limit": 1e30,
    "nem_sunset_year": 9999.0,
    "switch_min_kw": 1e30,
    "switch_max_kw": 1e30,
}


def pad_table(table: AgentTable, multiple: int) -> AgentTable:
    """Re-pad ``table`` so N is a multiple of ``multiple``; new rows carry
    mask 0 and the same inert fills as :func:`build_agent_table`."""
    n = table.n_agents
    n_new = pad_to_multiple(n, multiple)
    if n_new == n:
        return table
    pad = n_new - n

    def extend(x, fill=0):
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=0)

    repl = {}
    for f in dataclasses.fields(AgentTable):
        if f.name in ("incentives", "n_states"):
            continue
        repl[f.name] = extend(getattr(table, f.name), _PAD_FILLS.get(f.name, 0))
    inc = IncentiveParams(**{
        f.name: extend(getattr(table.incentives, f.name))
        for f in dataclasses.fields(IncentiveParams)
    })
    return dataclasses.replace(table, incentives=inc, **repl)


def build_agent_table(
    *,
    state_idx: np.ndarray,
    sector_idx: np.ndarray,
    region_idx: np.ndarray,
    tariff_idx: np.ndarray,
    load_idx: np.ndarray,
    cf_idx: np.ndarray,
    customers_in_bin: np.ndarray,
    load_kwh_per_customer_in_bin: np.ndarray,
    developable_frac: np.ndarray,
    n_states: int,
    agent_id: np.ndarray | None = None,
    incentives: dict | None = None,
    tariff_switch_idx: np.ndarray | None = None,
    one_time_charge: np.ndarray | None = None,
    nem_kw_limit: np.ndarray | None = None,
    nem_first_year: np.ndarray | None = None,
    nem_sunset_year: np.ndarray | None = None,
    switch_min_kw: np.ndarray | None = None,
    switch_max_kw: np.ndarray | None = None,
    pad_multiple: int = 128,
    device="cuda",
) -> AgentTable:
    """Assemble and pad an :class:`AgentTable` from host arrays.

    Padding agents carry mask 0, zero customers and load, and point at
    index 0 of every bank. ``incentives``: optional dict of
    :class:`IncentiveParams` field -> [n, 2] host array.
    """
    dev = resolve_device(device)
    n = int(state_idx.shape[0])

    # fault site (kind ``corrupt``): malformed rows entering the table, a
    # NaN customer count and an out-of-range tariff reference on the
    # deterministic DGEN_TPU_FAULT_CORRUPT_ROWS rows. Load-time validation
    # (resilience.quarantine) must quarantine exactly these rows.
    if corrupt_point("ingest_corrupt_row") and n:
        rows = [int(r) % n for r in corrupt_rows()]
        customers_in_bin = np.array(np.asarray(customers_in_bin), dtype=np.float64)
        customers_in_bin[rows[0]] = np.nan
        if len(rows) > 1:
            tariff_idx = np.array(np.asarray(tariff_idx), dtype=np.int64)
            tariff_idx[rows[1]] = 2 ** 24

    n_pad = pad_to_multiple(max(n, 1), pad_multiple)

    def pad_i(a, fill=0):
        out = np.full(n_pad, fill, dtype=np.int32)
        out[:n] = np.asarray(a, dtype=np.int32)
        return out

    def pad_f(a, fill=0.0):
        out = np.full(n_pad, fill, dtype=np.float32)
        out[:n] = np.asarray(a, dtype=np.float32)
        return out

    mask = np.zeros(n_pad, dtype=np.float32)
    mask[:n] = 1.0

    n_sectors = len(SECTORS)
    group = np.asarray(state_idx, np.int32) * n_sectors + np.asarray(sector_idx, np.int32)

    inc = {}
    for f in dataclasses.fields(IncentiveParams):
        dtype = np.int32 if f.name == "pbi_years" else np.float32
        out = np.zeros((n_pad, 2), dtype=dtype)
        if incentives is not None and incentives.get(f.name) is not None:
            out[:n] = np.asarray(incentives[f.name])
        inc[f.name] = out

    if tariff_switch_idx is None:
        tariff_switch_idx = np.asarray(tariff_idx)
    if one_time_charge is None:
        one_time_charge = np.zeros(n, dtype=np.float32)
    # NEM defaults: unlimited NEM, window always open
    if nem_kw_limit is None:
        nem_kw_limit = np.full(n, 1e30, dtype=np.float32)
    if nem_first_year is None:
        nem_first_year = np.zeros(n, dtype=np.float32)
    if nem_sunset_year is None:
        nem_sunset_year = np.full(n, 9999.0, dtype=np.float32)
    # switch-window defaults: agents WITH a distinct DG rate switch at
    # any size; agents without one never enter the window
    has_switch = np.asarray(tariff_switch_idx) != np.asarray(tariff_idx)
    if switch_min_kw is None:
        switch_min_kw = np.where(has_switch, 0.0, 1e30).astype(np.float32)
    if switch_max_kw is None:
        switch_max_kw = np.full(n, 1e30, dtype=np.float32)

    cols = dict(
        agent_id=pad_i(np.arange(n) if agent_id is None else agent_id),
        mask=mask,
        state_idx=pad_i(state_idx),
        sector_idx=pad_i(sector_idx),
        group_idx=pad_i(group),
        region_idx=pad_i(region_idx),
        tariff_idx=pad_i(tariff_idx),
        tariff_switch_idx=pad_i(tariff_switch_idx),
        load_idx=pad_i(load_idx),
        cf_idx=pad_i(cf_idx),
        customers_in_bin=pad_f(customers_in_bin),
        load_kwh_per_customer_in_bin=pad_f(load_kwh_per_customer_in_bin),
        developable_frac=pad_f(developable_frac),
        one_time_charge=pad_f(one_time_charge),
        nem_kw_limit=pad_f(nem_kw_limit, fill=1e30),
        nem_first_year=pad_f(nem_first_year),
        nem_sunset_year=pad_f(nem_sunset_year, fill=9999.0),
        switch_min_kw=pad_f(switch_min_kw, fill=1e30),
        switch_max_kw=pad_f(switch_max_kw, fill=1e30),
    )
    t = lambda a: torch.from_numpy(a).to(dev)
    return AgentTable(
        **{k: t(v) for k, v in cols.items()},
        incentives=IncentiveParams(**{k: t(v) for k, v in inc.items()}),
        n_states=n_states,
    )
