"""Agent-package format: a self-contained on-disk population (port of
``dgen_tpu/io/package.py``).

A package is a directory:

    <pkg>/agents.npz          per-agent attributes, one array a column
                              (the JAX package writes agents.parquet)
    <pkg>/load_profiles.dgpb  [L, 8760] normalized load shapes (io.store)
    <pkg>/solar_cf.dgpb       [S, 8760] PV CF profiles
    <pkg>/wholesale.dgpb      [R, 8760] $/kWh sell-rate profiles
    <pkg>/tariffs.json        list of tariff spec dicts (ops.tariff)
    <pkg>/meta.json           states, n_states, format version

The port writes its agent columns with plain ``np.savez`` (no pickle)
and reads them with numpy alone, so loading a package onto the card
needs neither pandas nor pyarrow. A package the JAX package wrote
(``agents.parquet``) loads too: pandas is imported in that branch only.
The banks, ``tariffs.json`` and ``meta.json`` are the JAX layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.io import store
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank, build_agent_table
from dgen_tpu_torch.ops.tariff import TariffBank, compile_tariffs

FORMAT_VERSION = 1

#: per-agent columns every package carries
AGENT_COLUMNS = (
    "state_idx", "sector_idx", "region_idx", "tariff_idx",
    "tariff_switch_idx", "load_idx", "cf_idx", "customers_in_bin",
    "load_kwh_per_customer_in_bin", "developable_frac", "one_time_charge",
)

#: optional per-agent policy columns (absent in format-1 packages
#: written before the NEM machine / size-conditioned switch; the
#: build_agent_table defaults apply on load)
POLICY_COLUMNS = (
    "nem_kw_limit", "nem_first_year", "nem_sunset_year",
    "switch_min_kw", "switch_max_kw",
)

#: IncentiveParams leaves stored as ``<leaf>_<slot>`` columns for the two
#: incentive slots; pbi_decay is optional on load
INCENTIVE_LEAVES = (
    "cbi_usd_p_w", "cbi_max_usd", "ibi_frac", "ibi_max_usd",
    "pbi_usd_p_kwh", "pbi_years", "pbi_decay",
)

AGENTS_NPZ = "agents.npz"
AGENTS_PARQUET = "agents.parquet"


@dataclasses.dataclass(frozen=True)
class Population:
    table: AgentTable
    profiles: ProfileBank
    tariffs: TariffBank
    states: List[str]
    tariff_specs: List[dict]


def atomic_write_json(path: str, obj, **dump_kw) -> None:
    """``json.dump`` to ``path`` through a temp sibling and one rename
    (:func:`io.store.atomic_write`)."""
    def _w(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, **dump_kw)

    store.atomic_write(path, _w)


def agent_columns(table: AgentTable) -> Dict[str, np.ndarray]:
    """Column name -> host array of the real (mask 1) rows of ``table``:
    the package's agent columns."""
    keep = table.mask.cpu().numpy() > 0
    cols = {c: getattr(table, c).cpu().numpy()[keep]
            for c in AGENT_COLUMNS + POLICY_COLUMNS}
    for leaf in INCENTIVE_LEAVES:
        vals = getattr(table.incentives, leaf).cpu().numpy()[keep]  # [n, 2]
        for slot in range(vals.shape[1]):
            cols[f"{leaf}_{slot}"] = vals[:, slot]
    return cols


def save_population(
    pkg_dir: str,
    table: AgentTable,
    profiles: ProfileBank,
    tariff_specs: Sequence[dict],
    states: Sequence[str],
    quant_banks: bool = False,
) -> None:
    """Write a population package (unpadded rows only), its agent
    columns as ``agents.npz``.

    ``quant_banks`` writes the load and solar banks int8-quantized with
    per-row float32 scale sidecars (store dtype code 2), which
    :func:`load_population` dequantizes; wholesale stays float32."""
    os.makedirs(pkg_dir, exist_ok=True)
    cols = agent_columns(table)

    def _w(tmp: str) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **cols)

    store.atomic_write(os.path.join(pkg_dir, AGENTS_NPZ), _w)

    bank_dtype = "int8" if quant_banks else None
    store.write_bank(os.path.join(pkg_dir, "load_profiles.dgpb"),
                     profiles.load, dtype=bank_dtype)
    store.write_bank(os.path.join(pkg_dir, "solar_cf.dgpb"),
                     profiles.solar_cf, dtype=bank_dtype)
    store.write_bank(os.path.join(pkg_dir, "wholesale.dgpb"), profiles.wholesale)

    def jsonable(spec: dict) -> dict:
        return {k: v.tolist() if isinstance(v, np.ndarray) else v
                for k, v in spec.items()}

    atomic_write_json(os.path.join(pkg_dir, "tariffs.json"),
                      [jsonable(s) for s in tariff_specs])
    atomic_write_json(
        os.path.join(pkg_dir, "meta.json"),
        {
            "format_version": FORMAT_VERSION,
            "states": list(states),
            "n_states": int(table.n_states),
            "n_agents": int(len(cols["state_idx"])),
        },
    )


def read_agent_columns(pkg_dir: str) -> Dict[str, np.ndarray]:
    """The package's agent columns: ``agents.npz`` with numpy alone, or
    a JAX package's ``agents.parquet`` through pandas."""
    npz = os.path.join(pkg_dir, AGENTS_NPZ)
    if os.path.exists(npz):
        with np.load(npz, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    parquet = os.path.join(pkg_dir, AGENTS_PARQUET)
    if not os.path.exists(parquet):
        raise FileNotFoundError(f"{pkg_dir} holds neither {AGENTS_NPZ} nor "
                                f"{AGENTS_PARQUET}")
    import pandas as pd

    df = pd.read_parquet(parquet)
    return {c: df[c].to_numpy() for c in df.columns}


def load_population(pkg_dir: str, pad_multiple: int = 128,
                    device="cuda") -> Population:
    """Load a package into the port's containers on ``device``: the agent
    table padded to ``pad_multiple``, the profile banks (a bfloat16 bank
    as ``torch.bfloat16``, an int8 bank dequantized to float32) and the
    compiled tariff bank."""
    dev = resolve_device(device)
    with open(os.path.join(pkg_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"package format {meta.get('format_version')} != {FORMAT_VERSION}")

    cols = read_agent_columns(pkg_dir)
    missing = set(AGENT_COLUMNS) - set(cols)
    if missing:
        raise ValueError(f"{pkg_dir}: agent columns missing: {sorted(missing)}")

    incentives = None
    if all(f"{leaf}_0" in cols for leaf in INCENTIVE_LEAVES if leaf != "pbi_decay"):
        incentives = {
            leaf: np.stack([cols[f"{leaf}_0"], cols[f"{leaf}_1"]], axis=1).astype(
                np.int32 if leaf == "pbi_years" else np.float32)
            for leaf in INCENTIVE_LEAVES if f"{leaf}_0" in cols
        }

    policy = {c: cols[c].astype(np.float32) for c in POLICY_COLUMNS if c in cols}
    table = build_agent_table(
        incentives=incentives,
        **policy,
        **{c: cols[c] for c in AGENT_COLUMNS},
        n_states=int(meta["n_states"]),
        pad_multiple=pad_multiple,
        device=dev,
    )
    profiles = ProfileBank(**{
        name: store.read_bank(os.path.join(pkg_dir, f"{stem}.dgpb")).to(dev)
        for name, stem in (("load", "load_profiles"), ("solar_cf", "solar_cf"),
                           ("wholesale", "wholesale"))
    })
    with open(os.path.join(pkg_dir, "tariffs.json")) as f:
        specs = json.load(f)
    return Population(
        table=table, profiles=profiles, tariffs=compile_tariffs(specs, device=dev),
        states=list(meta["states"]), tariff_specs=specs,
    )
