"""National-scale synthetic world generator (port of
``dgen_tpu/models/synth.py``).

:mod:`dgen_tpu_torch.io.synth` builds the small worlds in one draw of one
RNG stream. A national world needs more:

* **1M/10M-row worlds in O(chunk) host memory**: columns are generated
  in fixed :data:`NationalSpec.gen_chunk` row blocks, each from its own
  counter-seeded RNG, so the transient working set is one block whatever
  the table's size.
* **Bytes independent of how the table is materialized**: block ``i``
  always draws from ``SeedSequence((seed, i))``, so the whole table, a
  range of it, or one shard (``rows=``) hold identical bytes.
* **State-stratified strata**: rows are laid out state-major with
  per-state counts allocated from census-scale population shares
  (largest remainder, so the strata are exact and deterministic).
* **Banks saved small**: a world saves as an agent package
  (:mod:`dgen_tpu_torch.io.package`) whose load and solar DGPB banks are
  int8 with per-row float32 scale sidecars (store dtype code 2), plus a
  hashed ``world.json`` manifest that re-verifies the world against its
  spec.

The numpy draws are the JAX generator's, in the same order, so a spec
gives the same columns byte for byte and :func:`column_hashes` the same
digests. The tables and banks are built as the port's containers on the
``device`` the caller names (the card by default). One difference on
disk: the port's package keeps its agent columns in ``agents.npz``
(numpy, no pandas), so ``world.json``'s ``files`` names ``agents.npz``
where the JAX package's names ``agents.parquet``; the banks,
``tariffs.json`` and ``meta.json`` are byte for byte the JAX package's.

CLI: ``python -m dgen_tpu_torch.models.synth generate | verify | smoke``
(the JAX flags; ``smoke`` runs on one device, ``--device cpu`` for the
plain versions; ``--mesh HxD`` spawns H x D ranks on a localhost gloo
rendezvous, each generating its own block of rows (:func:`shard_rows`),
and refuses a mesh whose blocks would hold fewer than
:data:`SMOKE_ROW_PAD` rows).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.io.synth import (
    N_STATES,
    STATE_IDX,
    STATES,
    SynthPopulation,
    make_load_profiles,
    make_solar_cf_profiles,
    make_tariff_specs,
    make_wholesale_prices,
)
from dgen_tpu_torch.models.agents import (
    AgentTable,
    ProfileBank,
    build_agent_table,
    pad_table,
    pad_to_multiple,
)
from dgen_tpu_torch.ops.tariff import NET_BILLING, NET_METERING, compile_tariffs
from dgen_tpu_torch.tree import tree_map

#: approximate 2020-census population shares (percent) over the
#: contiguous-US + DC modeling universe (io.synth.STATES): the strata
#: weights of a national table, normalized over the spec's states
STATE_SHARES: Dict[str, float] = {
    "AL": 1.51, "AR": 0.91, "AZ": 2.16, "CA": 11.91, "CO": 1.74,
    "CT": 1.09, "DC": 0.21, "DE": 0.30, "FL": 6.49, "GA": 3.23,
    "IA": 0.96, "ID": 0.55, "IL": 3.86, "IN": 2.04, "KS": 0.88,
    "KY": 1.36, "LA": 1.40, "MA": 2.12, "MD": 1.86, "ME": 0.41,
    "MI": 3.03, "MN": 1.72, "MO": 1.85, "MS": 0.89, "MT": 0.33,
    "NC": 3.15, "ND": 0.23, "NE": 0.59, "NH": 0.42, "NJ": 2.80,
    "NM": 0.64, "NV": 0.94, "NY": 6.08, "OH": 3.55, "OK": 1.19,
    "OR": 1.28, "PA": 3.91, "RI": 0.33, "SC": 1.54, "SD": 0.27,
    "TN": 2.08, "TX": 8.77, "UT": 0.98, "VA": 2.60, "VT": 0.19,
    "WA": 2.32, "WI": 1.77, "WV": 0.54, "WY": 0.17,
}

#: rows per generation block, the determinism unit (part of the seed
#: contract: changing it changes the RNG stream, like the seed)
GEN_CHUNK = 131072

#: tariff corpus selectors: "mixed" is the full synthetic corpus plus a
#: TOU + tiered net-billing rate; "nem" keeps the net-metering subset, so
#: run_static_flags proves net_billing=False and sizing prices bills by
#: the linear identity
TARIFF_MIXES = ("mixed", "nem")

#: the dynamic-population sentinel of a padding row's entry year (the JAX
#: package's ``dgen_tpu.ensemble.cohorts.COHORT_NEVER``)
COHORT_NEVER = 9.0e9


@dataclasses.dataclass(frozen=True)
class NationalSpec:
    """Seed contract for a national synthetic world: two equal specs
    generate byte-identical tables and banks, however materialized."""

    n_agents: int
    seed: int = 0
    states: Tuple[str, ...] = tuple(STATES)
    sector_weights: Tuple[float, float, float] = (0.7, 0.2, 0.1)
    tariff_mix: str = "mixed"
    n_regions: int = 10
    rate_switch_frac: float = 0.0
    gen_chunk: int = GEN_CHUNK
    #: bank corpus sizes (richer than the io.synth defaults)
    load_profiles_per_sector: int = 8
    n_cf_profiles: int = 16
    #: this fraction of rows is future construction, entering uniformly
    #: over ``cohort_years``: :func:`generate_table` reserves those rows
    #: masked and :func:`generate_entry_years` gives their entry years.
    #: 0.0 (the default) draws no extra RNG.
    cohort_frac: float = 0.0
    cohort_years: Tuple[int, int] = (2026, 2040)

    def __post_init__(self) -> None:
        if self.n_agents < 1:
            raise ValueError("n_agents must be >= 1")
        if self.gen_chunk < 1:
            raise ValueError("gen_chunk must be >= 1")
        if self.tariff_mix not in TARIFF_MIXES:
            raise ValueError(
                f"tariff_mix {self.tariff_mix!r} not in {TARIFF_MIXES}")
        unknown = [s for s in self.states if s not in STATE_IDX]
        if unknown:
            raise ValueError(f"unknown states {unknown}")
        if abs(sum(self.sector_weights) - 1.0) > 1e-6:
            raise ValueError("sector_weights must sum to 1")
        if not (0.0 <= self.cohort_frac < 1.0):
            raise ValueError(
                f"cohort_frac must be in [0, 1), got {self.cohort_frac}")
        y0, y1 = self.cohort_years
        if y0 > y1 or y0 < 1:
            raise ValueError(
                f"cohort_years must be an ascending positive pair, "
                f"got {self.cohort_years}")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["states"] = list(self.states)
        d["sector_weights"] = list(self.sector_weights)
        d["cohort_years"] = list(self.cohort_years)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "NationalSpec":
        d = dict(d)
        d["states"] = tuple(d["states"])
        d["sector_weights"] = tuple(d["sector_weights"])
        if "cohort_years" in d:
            d["cohort_years"] = tuple(d["cohort_years"])
        return cls(**d)


def state_counts(spec: NationalSpec) -> np.ndarray:
    """Exact per-state row counts: largest-remainder allocation of
    ``n_agents`` over the normalized population shares (ties broken by
    state order)."""
    w = np.asarray([STATE_SHARES[s] for s in spec.states], np.float64)
    w = w / w.sum()
    exact = w * spec.n_agents
    base = np.floor(exact).astype(np.int64)
    short = spec.n_agents - int(base.sum())
    order = np.argsort(-(exact - base), kind="stable")
    base[order[:short]] += 1
    return base


def _state_bounds(spec: NationalSpec) -> np.ndarray:
    """[n_spec_states] cumulative row bounds of the state-major layout."""
    return np.cumsum(state_counts(spec))


#: the residential cluster-shape distribution of a ``"mixed"`` world
#: (ops.tariffcluster's structural keys): flat (1 period, 1 tier), tiered
#: (1 period, 2 tiers), TOU (2 periods, 1 tier), TOU + tiers (2 periods,
#: 2 tiers). Pools index :func:`make_national_tariffs`'s "mixed" corpus;
#: :func:`save_world` stamps them into ``world.json`` with the realized
#: histogram.
MIXED_SHAPE_CLASSES = ("flat", "tiered", "tou", "tou_tiered")
MIXED_SHAPE_WEIGHTS = (0.35, 0.30, 0.25, 0.10)
MIXED_SHAPE_POOLS = ((0, 1), (2,), (3, 4), (6,))


def make_national_tariffs(mix: str) -> list:
    """The tariff corpus of a mix, as raw spec dicts.

    ``"nem"`` keeps the net-metering specs of the synthetic corpus.
    ``"mixed"`` is the full corpus plus a TOU + tiered residential
    net-billing rate inserted before the DG rate, which stays last
    (``_chunk_columns`` resolves it as ``n_tariffs - 1``)."""
    specs = make_tariff_specs()
    if mix == "mixed":
        wkday = np.zeros((12, 24), dtype=int)
        wkday[:, 16:21] = 1
        tou_tiered = {
            "price": [[0.11, 0.17], [0.26, 0.33]],
            "tier_cap": [600.0, 1e38],
            "e_wkday_12by24": wkday,
            "e_wkend_12by24": np.zeros((12, 24), dtype=int),
            "fixed_charge": 10.0, "metering": NET_BILLING,
        }
        return specs[:-1] + [tou_tiered] + specs[-1:]
    return [s for s in specs if s.get("metering") == NET_METERING]


def _chunk_columns(spec: NationalSpec, ci: int, bounds: np.ndarray,
                   n_tariffs: int, res_tariffs, com_tariffs: np.ndarray,
                   ind_tariff: int) -> dict:
    """Every column of generation block ``ci`` (the full block), from the
    block's own counter-seeded RNG; the draws are the JAX generator's, in
    its order."""
    lo = ci * spec.gen_chunk
    hi = min(lo + spec.gen_chunk, spec.n_agents)
    n = hi - lo
    rng = np.random.default_rng(np.random.SeedSequence((spec.seed, ci)))

    # state-major strata from the cumulative bounds, no RNG involved
    local_state = np.searchsorted(bounds, np.arange(lo, hi), side="right")
    local_state = local_state.astype(np.int32)
    global_state = np.asarray(
        [STATE_IDX[s] for s in spec.states], np.int32)[local_state]

    # normalized before the draw: the spec accepts weights to 1e-6,
    # Generator.choice demands ~1.5e-8
    w = np.asarray(spec.sector_weights, np.float64)
    sector = rng.choice(3, size=n, p=w / w.sum()).astype(np.int32)
    lps = spec.load_profiles_per_sector
    load_idx = (sector * lps + rng.integers(0, lps, n)).astype(np.int32)
    cf_idx = np.clip(
        (global_state.astype(np.int64) * spec.n_cf_profiles) // N_STATES
        + rng.integers(-1, 2, n),
        0, spec.n_cf_profiles - 1,
    ).astype(np.int32)
    region_idx = (global_state % spec.n_regions).astype(np.int32)

    load_kwh = np.where(
        sector == 0,
        np.exp(rng.uniform(np.log(4e3), np.log(1.5e4), n)),
        np.where(
            sector == 1,
            np.exp(rng.uniform(np.log(3e4), np.log(4e5), n)),
            np.exp(rng.uniform(np.log(4e5), np.log(4e6), n)),
        ),
    ).astype(np.float32)
    customers = np.exp(
        rng.uniform(np.log(50.0), np.log(5000.0), n)).astype(np.float32)
    developable = rng.uniform(0.2, 0.95, n).astype(np.float32)

    if isinstance(res_tariffs, tuple):
        # mixed worlds: a shape class by MIXED_SHAPE_WEIGHTS, then a
        # uniform member of its pool (a wide draw modulo the pool size, so
        # the RNG call count does not depend on the pools)
        pool_arr, pool_len, wts = res_tariffs
        shape_cls = rng.choice(len(pool_len), size=n, p=wts)
        member = rng.integers(0, 1 << 62, n)
        res_draw = pool_arr[shape_cls, member % pool_len[shape_cls]]
    else:
        res_draw = res_tariffs[rng.integers(0, len(res_tariffs), n)]
    tariff_idx = np.where(
        sector == 0,
        res_draw,
        np.where(
            sector == 1,
            com_tariffs[rng.integers(0, len(com_tariffs), n)],
            ind_tariff,
        ),
    ).astype(np.int32)
    switch = (rng.random(n) < spec.rate_switch_frac) & (sector == 0)
    dg_rate = n_tariffs - 1   # the corpus' DG rate is always last
    tariff_switch_idx = np.where(switch, dg_rate, tariff_idx).astype(np.int32)
    one_time_charge = np.where(
        switch, rng.uniform(100.0, 800.0, n), 0.0).astype(np.float32)

    # cohort entry draws come last, and only when cohort_frac > 0
    if spec.cohort_frac > 0.0:
        y0, y1 = spec.cohort_years
        is_cohort = rng.random(n) < spec.cohort_frac
        entry_year = np.where(
            is_cohort, rng.integers(y0, y1 + 1, n), 0,
        ).astype(np.float32)
    else:
        entry_year = np.zeros(n, np.float32)

    return dict(
        state_idx=global_state,
        sector_idx=sector,
        region_idx=region_idx,
        tariff_idx=tariff_idx,
        tariff_switch_idx=tariff_switch_idx,
        load_idx=load_idx,
        cf_idx=cf_idx,
        customers_in_bin=customers,
        load_kwh_per_customer_in_bin=load_kwh,
        developable_frac=developable,
        one_time_charge=one_time_charge,
        entry_year=entry_year,
    )


#: generated column order (the world manifest hashes in this order;
#: entry_year last)
COLUMNS = (
    "state_idx", "sector_idx", "region_idx", "tariff_idx",
    "tariff_switch_idx", "load_idx", "cf_idx", "customers_in_bin",
    "load_kwh_per_customer_in_bin", "developable_frac", "one_time_charge",
    "entry_year",
)


def _tariff_pools(spec: NationalSpec) -> tuple:
    """(n_tariffs, res_pool, com_pool, ind_tariff) of a mix: index pools
    into :func:`make_national_tariffs`'s corpus order (a mixed world's
    residential pool is the (pools, lengths, weights) triple)."""
    n = len(make_national_tariffs(spec.tariff_mix))
    if spec.tariff_mix == "nem":
        # corpus: [flat NEM, tiered NEM, commercial TOU NEM, DG rate]
        return n, np.asarray([0, 1], np.int32), \
            np.asarray([1, 2], np.int32), 2
    width = max(len(p) for p in MIXED_SHAPE_POOLS)
    pool_arr = np.zeros((len(MIXED_SHAPE_POOLS), width), np.int32)
    pool_len = np.zeros(len(MIXED_SHAPE_POOLS), np.int64)
    for i, p in enumerate(MIXED_SHAPE_POOLS):
        pool_arr[i, :len(p)] = p
        pool_len[i] = len(p)
    res = (pool_arr, pool_len,
           np.asarray(MIXED_SHAPE_WEIGHTS, np.float64))
    return n, res, np.asarray([1, 3, 5], np.int32), 5


def generate_columns(
    spec: NationalSpec,
    start: int = 0,
    stop: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Columns of rows ``[start, stop)``, byte-identical to the same slice
    of the whole table (each covering block is generated in full from its
    own RNG and sliced)."""
    stop = spec.n_agents if stop is None else stop
    if not (0 <= start <= stop <= spec.n_agents):
        raise ValueError(
            f"row range [{start}, {stop}) outside [0, {spec.n_agents})")
    bounds = _state_bounds(spec)
    n_tariffs, res_p, com_p, ind_t = _tariff_pools(spec)
    out = {c: [] for c in COLUMNS}
    if stop > start:
        for ci in range(start // spec.gen_chunk, (stop - 1) // spec.gen_chunk + 1):
            cols = _chunk_columns(spec, ci, bounds, n_tariffs, res_p, com_p,
                                  ind_t)
            lo = ci * spec.gen_chunk
            a = max(start - lo, 0)
            b = min(stop - lo, spec.gen_chunk)
            for c in COLUMNS:
                out[c].append(cols[c][a:b])
    return {
        c: (np.concatenate(v) if v else
            np.empty(0, np.int32 if c.endswith("idx") else np.float32))
        for c, v in out.items()
    }


def _hash_columns(cols: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Per-column sha256 of the columns' raw bytes (the same byte stream
    :func:`column_hashes` walks block by block)."""
    return {
        c: hashlib.sha256(
            np.ascontiguousarray(cols[c]).tobytes()).hexdigest()
        for c in COLUMNS
    }


def column_hashes(spec: NationalSpec) -> Dict[str, str]:
    """Per-column sha256 of the whole table's bytes, accumulated block by
    block (O(chunk) memory): the world manifest's fingerprint."""
    bounds = _state_bounds(spec)
    n_tariffs, res_p, com_p, ind_t = _tariff_pools(spec)
    hashers = {c: hashlib.sha256() for c in COLUMNS}
    n_blocks = (spec.n_agents + spec.gen_chunk - 1) // spec.gen_chunk
    for ci in range(n_blocks):
        cols = _chunk_columns(spec, ci, bounds, n_tariffs, res_p, com_p,
                              ind_t)
        for c in COLUMNS:
            hashers[c].update(np.ascontiguousarray(cols[c]).tobytes())
    return {c: h.hexdigest() for c, h in hashers.items()}


def _reserve_cohort_rows(table: AgentTable,
                         entry_year: np.ndarray) -> AgentTable:
    """The mask zeroed on rows with a future entry year (cohort rows ship
    reserved: placed and padded with everyone else, invisible to a plain
    Simulation)."""
    alive = table.mask.clone()
    alive[:len(entry_year)] *= torch.from_numpy(
        (entry_year == 0.0).astype(np.float32)).to(alive.device)
    return dataclasses.replace(table, mask=alive)


def generate_table(
    spec: NationalSpec,
    rows: Optional[Tuple[int, int]] = None,
    pad_multiple: int = 128,
    device="cuda",
) -> AgentTable:
    """The :class:`AgentTable` of the whole world, or with ``rows=(start,
    stop)`` of one shard of it, on ``device``. Shard tables carry global
    agent ids. Cohort rows (``spec.cohort_frac > 0``) come back masked;
    :func:`generate_entry_years` gives their entry years."""
    start, stop = rows if rows is not None else (0, spec.n_agents)
    cols = generate_columns(spec, start, stop)
    entry_year = cols.pop("entry_year")
    table = build_agent_table(
        n_states=N_STATES,
        pad_multiple=pad_multiple,
        agent_id=np.arange(start, stop, dtype=np.int64),
        device=device,
        **cols,
    )
    if spec.cohort_frac > 0.0:
        table = _reserve_cohort_rows(table, entry_year)
    return table


def generate_entry_years(
    spec: NationalSpec,
    rows: Optional[Tuple[int, int]] = None,
    pad_multiple: int = 128,
) -> np.ndarray:
    """[N_padded] float32 entry years aligned row for row with
    :func:`generate_table` (same pad rule): 0.0 alive at start, a calendar
    year for a cohort row, :data:`COHORT_NEVER` on padding rows."""
    start, stop = rows if rows is not None else (0, spec.n_agents)
    entry = generate_columns(spec, start, stop)["entry_year"]
    n = stop - start
    out = np.full(pad_to_multiple(max(n, 1), pad_multiple),
                  COHORT_NEVER, dtype=np.float32)
    out[:n] = entry
    return out


def generate_banks(spec: NationalSpec, device="cuda") -> ProfileBank:
    """The world's float32 profile banks on ``device`` (quantized at save
    time or under ``RunConfig.quant_banks``)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(a).to(dev)
    return ProfileBank(
        load=t(make_load_profiles(
            n_per_sector=spec.load_profiles_per_sector, seed=spec.seed)),
        solar_cf=t(make_solar_cf_profiles(
            spec.n_cf_profiles, seed=spec.seed + 1)),
        wholesale=t(make_wholesale_prices(
            spec.n_regions, seed=spec.seed + 2)),
    )


def generate_world(
    spec: NationalSpec,
    rows: Optional[Tuple[int, int]] = None,
    pad_multiple: int = 128,
    device="cuda",
) -> SynthPopulation:
    """Table (whole or shard), banks and compiled tariffs on ``device``."""
    dev = resolve_device(device)
    return SynthPopulation(
        table=generate_table(spec, rows=rows, pad_multiple=pad_multiple,
                             device=dev),
        profiles=generate_banks(spec, device=dev),
        tariffs=compile_tariffs(make_national_tariffs(spec.tariff_mix),
                                device=dev),
        n_regions=spec.n_regions,
    )


# ---------------------------------------------------------------------------
# On-disk worlds: agent packages with a hashed world manifest
# ---------------------------------------------------------------------------

WORLD_MANIFEST = "world.json"

_BANK_FILES = ("load_profiles.dgpb", "solar_cf.dgpb", "wholesale.dgpb")

#: package files hashed as written (agents.npz holds the rows a
#: Simulation loads)
_PKG_FILES = ("agents.npz", "tariffs.json", "meta.json")


def _file_sha256(path: str) -> str:
    from dgen_tpu_torch.resilience.manifest import _sha256_file

    return _sha256_file(path)


def save_world(
    spec: NationalSpec,
    out_dir: str,
    quant_banks: bool = True,
) -> dict:
    """Generate and write a world as an agent package
    (:func:`dgen_tpu_torch.io.package.load_population` loads it).

    ``quant_banks`` (default) writes the load and solar DGPB banks int8
    with per-row float32 scale sidecars; wholesale stays float32. The
    table is built on the CPU (the package is host data). Returns the
    ``world.json`` manifest (spec, column and file hashes) it wrote."""
    from dgen_tpu_torch.io import package

    # one generation pass feeds the table and the manifest's hashes
    cols = generate_columns(spec)
    col_hashes = _hash_columns(cols)
    # cohort rows are saved alive: the package carries the full potential
    # population, and the entry schedule re-derives from the spec
    entry_year = cols.pop("entry_year")
    table = build_agent_table(
        n_states=N_STATES, pad_multiple=128,
        agent_id=np.arange(spec.n_agents, dtype=np.int64), device="cpu", **cols,
    )
    package.save_population(
        out_dir, table, generate_banks(spec, device="cpu"),
        make_national_tariffs(spec.tariff_mix), list(spec.states),
        quant_banks=quant_banks,
    )
    manifest = {
        "format": 1,
        "spec": spec.to_json(),
        "quant_banks": bool(quant_banks),
        "columns": col_hashes,
        "banks": {
            f: _file_sha256(os.path.join(out_dir, f)) for f in _BANK_FILES
        },
        "files": {
            f: _file_sha256(os.path.join(out_dir, f)) for f in _PKG_FILES
        },
    }
    if spec.cohort_frac > 0.0:
        sel = entry_year > 0.0
        ys, cs = np.unique(entry_year[sel].astype(np.int64),
                           return_counts=True)
        manifest["cohorts"] = {
            "cohort_frac": float(spec.cohort_frac),
            "cohort_years": list(spec.cohort_years),
            "n_cohort_rows": int(sel.sum()),
            "entry_histogram": {
                str(int(y)): int(c) for y, c in zip(ys, cs)
            },
        }
    if spec.tariff_mix == "mixed":
        # the documented shape distribution and what the seed realized
        # (residential rows only)
        t = cols["tariff_idx"][cols["sector_idx"] == 0]
        manifest["tariff_shape_mix"] = {
            "classes": list(MIXED_SHAPE_CLASSES),
            "weights": list(MIXED_SHAPE_WEIGHTS),
            "pools": [list(p) for p in MIXED_SHAPE_POOLS],
            "residential_histogram": {
                name: int(np.isin(t, pool).sum())
                for name, pool in zip(MIXED_SHAPE_CLASSES,
                                      MIXED_SHAPE_POOLS)
            },
        }
    package.atomic_write_json(os.path.join(out_dir, WORLD_MANIFEST), manifest)
    return manifest


def verify_world(world_dir: str) -> list:
    """Re-derive the world from its manifest's spec and compare hashes.
    Returns the problems found (empty = clean): a changed generator, a
    tampered bank or package file, or a stale manifest."""
    import json

    path = os.path.join(world_dir, WORLD_MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable {WORLD_MANIFEST}: {e}"]
    problems = []
    try:
        spec = NationalSpec.from_json(manifest["spec"])
    except (KeyError, TypeError, ValueError) as e:
        return [f"bad spec in {WORLD_MANIFEST}: {e}"]
    fresh = column_hashes(spec)
    for c, want in manifest.get("columns", {}).items():
        got = fresh.get(c)
        if got != want:
            problems.append(
                f"column {c}: generated {got} != recorded {want}")
    for kind, key in (("bank", "banks"), ("file", "files")):
        for f, want in manifest.get(key, {}).items():
            fp = os.path.join(world_dir, f)
            if not os.path.exists(fp):
                problems.append(f"{kind} {f}: missing")
            elif _file_sha256(fp) != want:
                problems.append(f"{kind} {f}: content hash mismatch")
    return problems


def shard_rows(spec: NationalSpec, shard: int, n_shards: int,
               pad_multiple: int = 1) -> Tuple[int, int]:
    """Contiguous row range of shard ``shard`` of ``n_shards`` (even
    split, remainder to the early shards; ``pad_multiple`` rounds the
    boundaries so each shard's table pads on its own)."""
    if not (0 <= shard < n_shards):
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    base = spec.n_agents // n_shards
    rem = spec.n_agents % n_shards
    if pad_multiple > 1 and base < pad_multiple:
        # spans smaller than one pad unit would empty the early shards
        raise ValueError(
            f"cannot split {spec.n_agents} rows into {n_shards} shards "
            f"at pad_multiple={pad_multiple}: each shard spans ~{base} "
            f"rows, fewer than one pad unit — grow the table, use "
            f"fewer shards, or drop the pad rounding")
    start = shard * base + min(shard, rem)
    stop = start + base + (1 if shard < rem else 0)
    if pad_multiple > 1:
        start = (start // pad_multiple) * pad_multiple
        if stop != spec.n_agents:
            stop = (stop // pad_multiple) * pad_multiple
    return start, stop


# ---------------------------------------------------------------------------
# CLI: generate / verify / smoke
# ---------------------------------------------------------------------------

def _spec_from_args(args) -> NationalSpec:
    y0, y1 = (int(v) for v in args.cohort_years.split(":"))
    return NationalSpec(
        n_agents=args.agents,
        seed=args.seed,
        states=tuple(args.states.split(",")) if args.states else tuple(STATES),
        tariff_mix=args.tariff_mix,
        n_regions=args.regions,
        rate_switch_frac=args.rate_switch_frac,
        gen_chunk=args.gen_chunk,
        cohort_frac=args.cohort_frac,
        cohort_years=(y0, y1),
    )


#: rows a rank's block of a multi-rank smoke is rounded to
#: (:func:`shard_rows`' ``pad_multiple``)
SMOKE_ROW_PAD = 16


def gather_shard_tables(table: AgentTable, topo) -> AgentTable:
    """The whole table from every rank's own rows (``generate_table(rows=
    shard_rows(...))``): each rank's table padded to the longest rank's
    rows with masked rows, then every leaf gathered in rank order. The
    padding rows are masked, so a state partition drops them."""
    n = topo.max_int(table.n_agents)
    if table.n_agents < n:
        table = pad_table(table, n)
    return tree_map(topo.all_gather, table)


def _smoke_rank(args, h: int, d: int) -> dict:
    """One rank of a multi-rank smoke: the rank generates its own block of
    rows (:func:`shard_rows`), the blocks are gathered into the whole
    table, and the run steps two years on the rank's state shard with the
    rank's export parts, checkpoint parts and shard ledger."""
    import time

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.io.export import RunExporter
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.parallel.launch import initialize_multihost
    from dgen_tpu_torch.parallel.mesh import shutdown
    from dgen_tpu_torch.resilience.manifest import RunManifest

    os.environ["DGEN_TPU_MESH"] = f"{h}x{d}"
    topo = initialize_multihost(args.coordinator, h * d, args.rank, device=args.device)
    try:
        spec = _spec_from_args(args)
        t0 = time.time()
        rows = shard_rows(spec, topo.rank, topo.world_size, pad_multiple=SMOKE_ROW_PAD)
        table = gather_shard_tables(
            generate_table(spec, rows=rows, pad_multiple=1, device=topo.device), topo)
        world = SynthPopulation(
            table=table, profiles=generate_banks(spec, device=topo.device),
            tariffs=compile_tariffs(make_national_tariffs(spec.tariff_mix),
                                    device=topo.device),
            n_regions=spec.n_regions)
        gen_s = time.time() - t0
        cfg = ScenarioConfig(name="synth-smoke", start_year=2014,
                             end_year=2016, anchor_years=())
        inputs = scen.uniform_inputs(cfg, n_groups=world.table.n_groups,
                                     n_regions=spec.n_regions, device=topo.device)
        sim = Simulation(world.table, world.profiles, world.tariffs, inputs, cfg,
                         RunConfig(sizing_iters=4), device=topo.device, ranks=topo)
        manifest = RunManifest(args.out, shard=topo.rank, n_processes=topo.world_size)
        exporter = RunExporter(
            args.out, agent_id=sim.host_agent_id, mask=sim.host_mask,
            manifest=manifest, device=topo.device, ranks=topo,
            meta={"smoke": {"mesh": args.mesh, "agents": spec.n_agents}})
        t0 = time.time()
        res = sim.run(callback=exporter, collect=False,
                      checkpoint_dir=os.path.join(args.out, "ckpt"))
        run_s = time.time() - t0
        report = manifest.verify()
        return {"rank": topo.rank, "rows": list(rows),
                "agents": int((sim.host_mask > 0).sum()),
                "years": [int(y) for y in res.years], "generate_s": round(gen_s, 2),
                "run_s": round(run_s, 2), "manifest_ok": report.ok,
                "manifest": report.to_json()}
    finally:
        shutdown()


def _smoke_mesh(args, h: int, d: int) -> int:
    """A multi-rank smoke: H x D ranks spawned as processes of this CLI
    over gloo (the CPU) on a localhost rendezvous, each stepping its
    shard; the run passes when every rank does and every shard ledger
    verifies."""
    import json
    import socket
    import subprocess
    import sys
    import tempfile

    spec = _spec_from_args(args)
    world = h * d
    for r in range(world):
        # refused before any process starts: a block under one pad unit
        shard_rows(spec, r, world, pad_multiple=SMOKE_ROW_PAD)
    run_dir = args.out or tempfile.mkdtemp(prefix="dgen-synth-smoke-")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cmd = [sys.executable, "-m", "dgen_tpu_torch.models.synth", "smoke",
           "--agents", str(args.agents), "--seed", str(args.seed),
           "--tariff-mix", args.tariff_mix, "--regions", str(args.regions),
           "--mesh", args.mesh, "--device", args.device, "--out", run_dir,
           "--coordinator", f"127.0.0.1:{port}"]
    if args.states:
        cmd += ["--states", args.states]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    ranks, ok = [], True
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                ok = False
            ok = ok and p.returncode == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        out = f.read()
        f.close()
        last = out.strip().splitlines()[-1:] or [""]
        try:
            ranks.append(json.loads(last[0]))
        except ValueError:
            ok = False
            ranks.append({"rank": r, "failed": out[-2000:]})
    ok = ok and all(rk.get("manifest_ok") and len(rk.get("years", ())) == 2
                    for rk in ranks)
    print(json.dumps({
        "smoke": "ok" if ok else "FAILED",
        "agents": spec.n_agents,
        "mesh": f"{h}x{d}",
        "device": args.device,
        "years": ranks[0].get("years", []),
        "manifest_ok": all(rk.get("manifest_ok") for rk in ranks),
        "ranks": ranks,
        "run_dir": run_dir,
    }))
    return 0 if ok else 1


def _smoke(args) -> int:
    """Generate a small world, step two model years with the exporter and
    checkpoints, and verify the run manifest: on one device, or with
    ``--mesh HxD`` over H x D spawned ranks (:func:`_smoke_mesh`)."""
    import json
    import tempfile
    import time

    from dgen_tpu_torch.parallel.mesh import parse_mesh_shape

    h, d = parse_mesh_shape(args.mesh)
    if args.rank is not None:
        print(json.dumps(_smoke_rank(args, h, d)))
        return 0
    if h * d > 1:
        return _smoke_mesh(args, h, d)

    from dgen_tpu_torch.config import RunConfig, ScenarioConfig
    from dgen_tpu_torch.io.export import RunExporter
    from dgen_tpu_torch.models import scenario as scen
    from dgen_tpu_torch.models.simulation import Simulation
    from dgen_tpu_torch.resilience.manifest import RunManifest

    dev = resolve_device(args.device)
    spec = _spec_from_args(args)
    t0 = time.time()
    world = generate_world(spec, device=dev)
    gen_s = time.time() - t0

    cfg = ScenarioConfig(name="synth-smoke", start_year=2014,
                         end_year=2016, anchor_years=())
    inputs = scen.uniform_inputs(
        cfg, n_groups=world.table.n_groups, n_regions=spec.n_regions,
        device=dev)
    run_dir = args.out or tempfile.mkdtemp(prefix="dgen-synth-smoke-")
    sim = Simulation(
        world.table, world.profiles, world.tariffs, inputs, cfg,
        RunConfig(sizing_iters=4), device=dev,
    )
    manifest = RunManifest(run_dir)
    exporter = RunExporter(
        run_dir, agent_id=sim.host_agent_id, mask=sim.host_mask,
        manifest=manifest, device=dev,
        meta={"smoke": {"mesh": args.mesh, "agents": spec.n_agents}},
    )
    t0 = time.time()
    res = sim.run(callback=exporter, collect=False,
                  checkpoint_dir=os.path.join(run_dir, "ckpt"))
    run_s = time.time() - t0
    report = manifest.verify()
    ok = report.ok and len(res.years) == len(cfg.model_years)
    print(json.dumps({
        "smoke": "ok" if ok else "FAILED",
        "agents": spec.n_agents,
        "mesh": f"{h}x{d}",
        "device": str(dev),
        "years": [int(y) for y in res.years],
        "generate_s": round(gen_s, 2),
        "run_s": round(run_s, 2),
        "manifest_ok": report.ok,
        "manifest": report.to_json(),
        "run_dir": run_dir,
    }))
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m dgen_tpu_torch.models.synth",
        description="national-scale synthetic world generator",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def world_args(sp):
        sp.add_argument("--agents", type=int, default=10_240)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--states", default="",
                        help="comma list (default: all 49)")
        sp.add_argument("--tariff-mix", choices=TARIFF_MIXES,
                        default="mixed")
        sp.add_argument("--regions", type=int, default=10)
        sp.add_argument("--rate-switch-frac", type=float, default=0.0)
        sp.add_argument("--gen-chunk", type=int, default=GEN_CHUNK)
        sp.add_argument("--cohort-frac", type=float, default=0.0,
                        help="fraction of rows reserved as future-"
                             "construction cohorts")
        sp.add_argument("--cohort-years", default="2026:2040",
                        help="y0:y1 entry-year range for cohort rows")

    g = sub.add_parser(
        "generate", help="write a world as an agent package (+ hashed "
        "world.json manifest)")
    world_args(g)
    g.add_argument("--out", required=True)
    g.add_argument("--no-quant-banks", action="store_true",
                   help="keep the DGPB banks float32 instead of int8+scales")

    v = sub.add_parser(
        "verify", help="re-derive a saved world from its manifest spec "
        "and compare hashes")
    v.add_argument("world_dir")

    s = sub.add_parser(
        "smoke", help="generate a small world, step 2 years on one device or "
        "over HxD spawned ranks, verify the run manifests")
    world_args(s)
    s.set_defaults(tariff_mix="nem")
    s.add_argument("--mesh", default="1x1",
                   help="HxD ranks (default 1x1: one process)")
    s.add_argument("--device", default="cuda",
                   help="the device the run steps on (default cuda)")
    s.add_argument("--out", default="",
                   help="run dir (default: a fresh temp dir)")
    s.add_argument("--timeout", type=float, default=900.0,
                   help="seconds a spawned rank may take (--mesh)")
    s.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    s.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)

    args = p.parse_args(argv)
    if args.cmd == "generate":
        spec = _spec_from_args(args)
        manifest = save_world(
            spec, args.out, quant_banks=not args.no_quant_banks)
        print(json.dumps({
            "world": args.out, "agents": spec.n_agents,
            "states": len(spec.states),
            "quant_banks": manifest["quant_banks"],
        }))
        return 0
    if args.cmd == "verify":
        problems = verify_world(args.world_dir)
        for prob in problems:
            print(f"verify: {prob}")
        print(json.dumps({"world": args.world_dir,
                          "clean": not problems,
                          "problems": len(problems)}))
        return 0 if not problems else 1
    return _smoke(args)


if __name__ == "__main__":
    raise SystemExit(main())
