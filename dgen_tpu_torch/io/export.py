"""Per-year run outputs (port of ``dgen_tpu/io/export.py``): the
reference's three result surfaces, written as numpy
``.npz`` partitions under the run directory, plus ``meta.json``
provenance.

The reference writes, per model year, the wide ``agent_outputs`` table,
the state-hourly net-load aggregate and the per-agent cash-flow series
(``agent_finance_series``). The JAX package writes them as parquet; the
port writes the same columns as ``.npz`` archives, so the card path
needs neither pandas nor pyarrow, and :func:`to_parquet` rewrites a run
directory into the JAX package's parquet layout on the CPU side.

Layout::

    <run_dir>/agent_outputs/year=<Y>.npz   agent_id, year, AGENT_OUTPUT_FIELDS
    <run_dir>/finance_series/year=<Y>.npz  agent_id, year, cash_flow [n, Y+1]
                                           (+ energy_value [n, Y] in full precision)
    <run_dir>/state_hourly/year=<Y>.npz    state, year, net_load_mw [S, 8760]
    <run_dir>/agents.npz                   the static per-agent frame
    <run_dir>/meta.json                    provenance

Every array is numeric or fixed-width unicode: nothing needs pickle.
Compact transfer (``DGEN_TPU_EXPORT_COMPACT``, on by default) quantizes
the bulky float fields to int16 on the device before the host fetch
(:func:`_quantize_i16`) and drops the ``energy_value`` detail column.

With a run manifest (``manifest=``, a
:class:`~dgen_tpu_torch.resilience.manifest.RunManifest`), every landed
partition and ``agents.npz`` is content-hash recorded after its rename,
and a year is marked complete once its surfaces are all on disk: the
run supervisor's resume frontier. The atomic writes carry the
``export_write`` and ``export_torn`` fault sites (``utils.atomic``).

A rank of a multi-rank run (``ranks=``, ``parallel``) writes its own
rows as ``year=<Y>-p<rank>.npz`` parts into the shared surfaces, in full
float32 as the JAX package's multi-process parts are (compact mode then
only drops the ``energy_value`` column); rank 0 writes ``meta.json`` and
the state-hourly aggregate (the same on every rank). A multi-rank run's
manifest must be a per-rank shard ledger
(``RunManifest(shard=rank)``); a one-run ledger is dropped, since it
would claim completeness it cannot see. :func:`load_surface` reads the
union of the parts.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import logging
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dgen_tpu_torch.io.hostio import to_host
from dgen_tpu_torch.utils.atomic import atomic_write, atomic_write_json, atomic_write_npz

logger = logging.getLogger(__name__)

#: the JAX package's parquet codec, used by :func:`to_parquet`
_PARQUET_COMPRESSION = "zstd"

#: the per-year surfaces, each a directory of ``year=<Y>.npz`` partitions
SURFACES = ("agent_outputs", "finance_series", "state_hourly")

#: the int16 code range of :func:`_quantize_i16` (symmetric, +-32766)
_Q_MAX = 32766.0
#: 1 / 32766 rounded to float32: the JAX package divides max|x| by the
#: constant 32766, and XLA compiles that as a product with this float32
#: reciprocal, so the port's scales take the same product
_Q_RECIP = float(np.float32(1.0) / np.float32(_Q_MAX))


def _quantize_i16(xs):
    """Symmetric int16 quantization of a list of float tensors, on their
    device: per-tensor scale = max|x| / 32766 (per column for a 2-D
    series), q = round(x / scale).

    Non-finite elements are zeroed first (one inf or NaN would poison the
    whole column's scale) and counted; the count rides back with the
    codes. The scale is max|x| times :data:`_Q_RECIP`, as XLA computes the
    JAX package's scale; ``x / scale`` is a true float32 division of two
    device tensors (a Python-scalar divisor would take a reciprocal
    product on a card); ``torch.round`` rounds half to even, as
    ``jnp.round`` does. So the codes and scales equal the JAX package's
    for the same float32 input. The error is at most max|x| / 65532 an
    element."""
    qs, scales, nonfinite = [], [], []
    for x in xs:
        bad = ~torch.isfinite(x)
        nonfinite.append(bad.sum(dtype=torch.int32))
        x = torch.where(bad, torch.zeros_like(x), x)
        if x.numel() == 0:
            m = x.new_zeros((1,) + tuple(x.shape[1:]) if x.ndim > 1 else ())
        elif x.ndim > 1:
            m = x.abs().amax(dim=0, keepdim=True)
        else:
            m = x.abs().amax()
        scale = torch.where(m > 0, m, torch.ones_like(m)).to(torch.float32) \
            * torch.full_like(m, _Q_RECIP, dtype=torch.float32)
        qs.append(torch.clamp(torch.round(x / scale), -_Q_MAX, _Q_MAX).to(torch.int16))
        scales.append(scale)
    return qs, scales, nonfinite


#: YearOutputs fields exported to agent_outputs (hourly arrays and the
#: cash flows get their own surfaces)
AGENT_OUTPUT_FIELDS = (
    "system_kw", "npv", "payback_period", "max_market_share",
    "market_share", "new_adopters", "number_of_adopters",
    "new_system_kw", "system_kw_cum", "market_value",
    "first_year_bill_with_system", "first_year_bill_without_system",
    "batt_kw", "batt_kwh", "new_batt_adopters", "batt_adopters_cum",
    "batt_kw_cum", "batt_kwh_cum",
    "carbon_intensity_t_per_kwh", "avoided_co2_t",
)

#: fields never quantized under compact transfer: the cumulative series
#: (whose year-over-year differences stay monotone at float32) and the
#: cumulative adopter count
_EXACT_FIELDS = frozenset(
    f for f in AGENT_OUTPUT_FIELDS if f.endswith("_cum")
) | {"number_of_adopters"}

#: quantization mask in AGENT_OUTPUT_FIELDS order
_AGENT_OUTPUT_QUANT = tuple(f not in _EXACT_FIELDS for f in AGENT_OUTPUT_FIELDS)

#: sector index -> the reference's sector_abbr vocabulary
SECTOR_ABBR = ("res", "com", "ind")


def _dir(run_dir: str, name: str) -> str:
    d = os.path.join(run_dir, name)
    os.makedirs(d, exist_ok=True)
    return d


def _part_name(year: int, rank: Optional[int] = None) -> str:
    """A year's partition name; a multi-rank run's rank writes its own part."""
    if rank is None:
        return f"year={int(year)}.npz"
    return f"year={int(year)}-p{int(rank)}.npz"


def _host_rows(arr, ranks=None, n_local: Optional[int] = None):
    """(rows, global_row_idx) of this rank's part of a per-agent field on
    the host: a rank's outputs are its own rows, global rows
    ``rank * n_local + arange(n_local)``; a field that arrives with every
    rank's rows (``world * n_local`` of them, in rank order) is cut to this
    rank's. ``global_row_idx`` is None for one process."""
    h = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if ranks is None or not ranks.distributed:
        return h, None
    n = h.shape[0] if n_local is None else int(n_local)
    start = ranks.rank * n
    if h.shape[0] == n * ranks.world_size:
        h = h[start:start + n]
    elif h.shape[0] != n:
        raise ValueError(f"a field of {h.shape[0]} rows is neither this rank's "
                         f"{n} rows nor the {ranks.world_size} ranks' {n * ranks.world_size}")
    return h, np.arange(start, start + n)


# ---------------------------------------------------------------------------
# Provenance stamps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def git_sha(root: Optional[str] = None) -> Optional[str]:
    """Short commit sha of the running checkout (None when the tree is
    not a git checkout or git is unavailable). Cached: exporters must not
    fork a subprocess per call."""
    if root is None:
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"],
                             cwd=root, capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def config_hash(*configs) -> Optional[str]:
    """12-hex digest over the given config objects (dataclasses field by
    field, dicts as they are), independent of field order. None when no
    configs are given."""
    if not configs:
        return None
    blob = json.dumps(
        [dataclasses.asdict(c) if dataclasses.is_dataclass(c) else c for c in configs],
        sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def provenance_stamp(*configs, device=None) -> Dict[str, object]:
    """The provenance record: git sha, config hash (when configs are
    given), and the device the run computes on. The JAX package's
    ``jax_backend`` key is ``backend`` here: the device type (``"cuda"``
    or ``"cpu"``; by default ``"cuda"`` when a card is present), with
    ``n_devices`` the cards visible (1 on the CPU)."""
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    return {
        "git_sha": git_sha(),
        "config_hash": config_hash(*configs),
        "backend": kind,
        "n_devices": torch.cuda.device_count() if kind == "cuda" else 1,
    }


class RunExporter:
    """Host-side per-year writer, used as a ``Simulation.run`` callback.

    ``mask`` drops padding agents; ``agent_id`` restores stable ids.
    ``static_frame`` (:func:`static_frame_from_table`) is written once as
    ``agents.npz``. ``device``: the run's device, for the provenance
    stamp. As a callback it is the serialized path (``__call__``, with
    ``prepare``); the host-I/O pipeline drives it through the split
    protocol (:meth:`device_payload` on the main thread,
    :meth:`write_host` on the io thread), which writes the same bytes.
    """

    def __init__(
        self,
        run_dir: str,
        agent_id: np.ndarray,
        mask: np.ndarray,
        state_names: Optional[Sequence[str]] = None,
        finance_series: bool = True,
        meta: Optional[Dict[str, object]] = None,
        compact: Optional[bool] = None,
        static_frame: Optional[Dict[str, np.ndarray]] = None,
        device=None,
        manifest=None,
        ranks=None,
    ) -> None:
        self.run_dir = run_dir
        #: a multi-rank run's topology (``parallel.mesh.RankTopology``):
        #: this exporter writes its rank's part; None for one process
        self.ranks = ranks if ranks is not None and ranks.distributed else None
        self._rank = None if self.ranks is None else self.ranks.rank
        # the crash-consistent artifact ledger (resilience.manifest): each
        # landed partition is recorded, each year marked complete once its
        # surfaces are all written. A multi-rank run records per rank (a
        # shard ledger); a one-run ledger there would claim completeness
        # it cannot see, so it is dropped
        if self.ranks is not None and manifest is not None \
                and getattr(manifest, "shard", None) is None:
            logger.warning("a multi-rank run needs a per-rank shard ledger "
                           "(RunManifest(shard=rank)); the run manifest is dropped")
            manifest = None
        self._manifest = manifest
        self.keep = np.asarray(mask) > 0
        self.agent_id = np.asarray(agent_id)[self.keep]
        self.state_names = list(state_names) if state_names else None
        self.finance_series = finance_series
        # compact transfer: int16-quantize the bulky float surfaces on the
        # device before the host fetch and drop the energy_value column
        # (DGEN_TPU_EXPORT_COMPACT=0 keeps full-precision float32 and the
        # column); the cumulative fields stay exact either way
        if compact is None:
            compact = os.environ.get(
                "DGEN_TPU_EXPORT_COMPACT", "1").lower() not in ("0", "off", "false")
        self.compact = bool(compact)
        self._prepared: Dict[int, dict] = {}   # year_idx -> dispatched payloads
        # non-finite elements zeroed before quantization: counted, stamped
        # into meta.json and logged at WARNING with the year and the field
        self._nonfinite_zeroed = 0
        self._nonfinite_by_field: Dict[str, int] = {}
        os.makedirs(run_dir, exist_ok=True)
        self.meta = {**provenance_stamp(device=device),
                     "n_agents": int(self.keep.sum()),
                     "export_compact": self.compact,
                     # a multi-rank run's parts stay float32 even under
                     # compact, as the JAX package's do
                     "export_quantized": self.compact and self.ranks is None,
                     "nonfinite_zeroed": 0,
                     # set (with per-year host_io_wall stamps) by
                     # stamp_hostio when the pipeline drives this exporter
                     "async_io": False,
                     **(meta or {})}
        self._meta_dirty = False
        if self.ranks is not None:
            self.meta["n_processes"] = self.ranks.world_size
        self._write_meta()
        if static_frame is not None and not self._rank:
            atomic_write_npz(os.path.join(run_dir, "agents.npz"), static_frame)
            if self._manifest is not None:
                self._manifest.record_run_artifact("agents.npz")

    @staticmethod
    def _quant_dispatch(arrs, quant):
        """The on-device quantization of the True-masked fields, not
        fetched: (qs, scales, rest, nonfinite) tensors. Dispatched right
        behind the step that produced ``arrs``; with no True field it is
        the identity bundle (the fields ride ``rest``)."""
        q_in = [a for a, q in zip(arrs, quant) if q]
        qs, scales, nonfinite = _quantize_i16(q_in) if q_in else ([], [], [])
        rest = [a for a, q in zip(arrs, quant) if not q]
        return qs, scales, rest, nonfinite

    def _host_reconstruct(self, host_prepared, quant, names=None, year=None) -> list:
        """Per-field host arrays in field order from a fetched (qs, scales,
        rest, nonfinite) bundle: the quantized fields reconstructed to
        float32, the zeroed non-finite count accumulated (and logged per
        field, with ``names`` in ``quant`` order)."""
        h_q, h_s, h_rest, h_nf = host_prepared
        self._nonfinite_zeroed += int(sum(int(c) for c in h_nf))
        if names is not None and any(int(c) for c in h_nf):
            q_names = [f for f, q in zip(names, quant) if q]
            for f, c in zip(q_names, h_nf):
                if int(c):
                    self._nonfinite_by_field[f] = self._nonfinite_by_field.get(f, 0) + int(c)
                    logger.warning(
                        "export: zeroed %d non-finite value(s) in '%s'%s before int16 "
                        "quantization; upstream data is producing poison (see the "
                        "health sentinel)", int(c), f,
                        "" if year is None else f" at year {year}")
        qi = iter(zip(h_q, h_s))
        ri = iter(h_rest)
        out = []
        for q in quant:
            if q:
                qv, s = next(qi)
                out.append(qv.astype(np.float32) * s)
            else:
                out.append(next(ri))
        return out

    @property
    def _quantized(self) -> bool:
        return self.compact and self.ranks is None

    def _ao_quant(self) -> tuple:
        return (_AGENT_OUTPUT_QUANT if self._quantized
                else (False,) * len(AGENT_OUTPUT_FIELDS))

    def _fin_quant(self) -> tuple:
        if not self.compact:
            return (False, False)
        return (True,) if self._quantized else (False,)

    def _fin_fields(self, outs) -> list:
        if not self.finance_series:
            return []
        return [outs.cash_flow] if self.compact else [outs.cash_flow,
                                                      outs.energy_value_pv_only]

    def _local_fields(self, arrs, quant, prepared=None, names=None, year=None) -> list:
        """Real-agent host rows of each field: one batched fetch of the
        prepared (or now dispatched) bundle, reconstructed."""
        if prepared is None:
            prepared = self._quant_dispatch(arrs, quant)
        host = self._host_reconstruct(to_host(list(prepared)), quant,
                                      names=names, year=year)
        return [self._rows(h) for h in host]

    def _rows(self, h: np.ndarray) -> np.ndarray:
        """The real-agent rows of a fetched field (a multi-rank field cut
        to this rank's rows first, :func:`_host_rows`)."""
        if self.ranks is not None:
            h = _host_rows(h, self.ranks, len(self.keep))[0]
        return h[self.keep]

    def _check_state_names(self, n_states: int) -> None:
        if self.state_names is not None and len(self.state_names) != n_states:
            raise ValueError(
                f"state_names has {len(self.state_names)} entries but the "
                f"hourly aggregate covers {n_states} states")

    def prepare(self, year: int, year_idx: int, outs) -> None:
        """Dispatch the compact quantization of a year whose callback is
        deferred, right after the step that produced ``outs``, so the
        later callback only fetches ready tensors. No-op in full
        precision."""
        if not self._quantized:
            return
        pre = {"agent_outputs": self._quant_dispatch(
            [getattr(outs, f) for f in AGENT_OUTPUT_FIELDS], _AGENT_OUTPUT_QUANT)}
        if self.finance_series:
            pre["finance"] = self._quant_dispatch([outs.cash_flow], (True,))
        self._prepared[int(year_idx)] = pre

    def __call__(self, year: int, year_idx: int, outs) -> None:
        pre = self._prepared.pop(int(year_idx), {})
        self.write_agent_outputs(year, outs, prepared=pre.get("agent_outputs"))
        if self.finance_series:
            self.write_finance_series(year, outs, prepared=pre.get("finance"))
        if outs.state_hourly_net_mw.numel() and not self._rank:
            self.write_state_hourly(year, to_host(outs.state_hourly_net_mw))
        self._flush_meta()
        self._mark_year_complete(year)

    # --- the host-I/O pipeline's split fetch/write protocol ------------
    # (io.hostio.ExportConsumer; __call__ above stays the serialized
    # parity oracle)

    def device_payload(self, year: int, year_idx: int, outs) -> dict:
        """Device-side export bundle of one year: the quantization (or the
        full-precision identity bundle) dispatched here, on the run loop
        thread right behind the step that produced ``outs``; the
        pipeline's fetch stage copies it to the host."""
        pre = self._prepared.pop(int(year_idx), {})
        payload = {"ao": pre.get("agent_outputs") or self._quant_dispatch(
            [getattr(outs, f) for f in AGENT_OUTPUT_FIELDS], self._ao_quant())}
        if self.finance_series:
            payload["fin"] = pre.get("finance") or self._quant_dispatch(
                self._fin_fields(outs), self._fin_quant())
        if outs.state_hourly_net_mw.numel() and not self._rank:
            payload["hourly"] = outs.state_hourly_net_mw
        return payload

    def write_host(self, year: int, year_idx: int, host) -> None:
        """Write stage of the pipeline over a fetched :meth:`device_payload`
        bundle: the same reconstruction, masking and columns as the
        serialized path, so the same bytes."""
        rows = [self._rows(h) for h in self._host_reconstruct(
            host["ao"], self._ao_quant(), names=AGENT_OUTPUT_FIELDS, year=year)]
        self._write_ao_frame(year, rows)
        if self.finance_series:
            f_rows = [self._rows(h) for h in self._host_reconstruct(
                host["fin"], self._fin_quant(),
                names=("cash_flow", "energy_value_pv_only"), year=year)]
            self._write_fin_frame(year, f_rows[0], None if self.compact else f_rows[1])
        if host.get("hourly") is not None:
            self.write_state_hourly(year, host["hourly"])
        self._flush_meta()
        self._mark_year_complete(year)

    def stamp_hostio(self, stats: Dict[str, object]) -> None:
        """Stamp the pipeline's provenance into meta.json: ``async_io``,
        the per-year ``host_io_wall`` (fetch + write seconds) and the
        overlap figures of ``io.hostio.HostPipeline.stats``."""
        self.meta["async_io"] = True
        self.meta["host_io_wall"] = {str(y): w for y, w in stats.get("years", {}).items()}
        for k in ("host_io_s", "host_blocked_s", "overlap_efficiency"):
            if k in stats:
                self.meta[k] = stats[k]
        self._meta_dirty = True
        self._flush_meta()

    def _write_meta(self) -> None:
        if self._rank:
            return  # rank 0 writes the run's provenance
        atomic_write_json(os.path.join(self.run_dir, "meta.json"), self.meta,
                          indent=2, default=str)

    def stamp_meta(self, **kv: object) -> None:
        """Merge extra provenance into meta.json and publish it (the
        supervisor stamps its recovery report here)."""
        self.meta.update(kv)
        self._meta_dirty = True
        self._flush_meta()

    def stamp_quarantine(self, summary: Dict[str, object]) -> None:
        """Merge a quarantine report's summary (resilience.quarantine)
        into the ``quarantine`` meta block: merged, not replaced, so the
        exporter's own ``nonfinite_zeroed_by_field`` and the load-time
        containment record stand side by side."""
        block = dict(self.meta.get("quarantine") or {})
        block.update(summary)
        self.meta["quarantine"] = block
        self._meta_dirty = True
        self._flush_meta()

    def _record(self, year: int, relpath: str) -> None:
        if self._manifest is not None:
            self._manifest.record_artifact(year, relpath)

    def _mark_year_complete(self, year: int) -> None:
        if self._manifest is not None:
            self._manifest.mark_year_complete(year)

    def _flush_meta(self) -> None:
        """Re-stamp meta.json when the provenance counters changed."""
        if (self.meta.get("nonfinite_zeroed") == self._nonfinite_zeroed
                and not self._meta_dirty):
            return
        self.meta["nonfinite_zeroed"] = int(self._nonfinite_zeroed)
        if self._nonfinite_by_field:
            block = dict(self.meta.get("quarantine") or {})
            block["nonfinite_zeroed_by_field"] = dict(self._nonfinite_by_field)
            self.meta["quarantine"] = block
        self._meta_dirty = False
        self._write_meta()

    # --- agent_outputs (reference dgen_model.py:460-462) ---
    def _write_ao_frame(self, year: int, rows) -> None:
        n = len(self.agent_id)
        name = _part_name(year, self._rank)
        atomic_write_npz(
            os.path.join(_dir(self.run_dir, "agent_outputs"), name),
            {"agent_id": self.agent_id, "year": np.full(n, int(year), np.int64),
             **dict(zip(AGENT_OUTPUT_FIELDS, rows))})
        self._record(year, os.path.join("agent_outputs", name))

    def write_agent_outputs(self, year: int, outs, prepared=None) -> None:
        self._write_ao_frame(year, self._local_fields(
            [getattr(outs, f) for f in AGENT_OUTPUT_FIELDS], self._ao_quant(),
            prepared=prepared, names=AGENT_OUTPUT_FIELDS, year=year))

    # --- agent_finance_series (reference finance_series_export.py:22) ---
    def _write_fin_frame(self, year: int, cf, ev) -> None:
        n = len(self.agent_id)
        cols = {"agent_id": self.agent_id, "year": np.full(n, int(year), np.int64),
                "cash_flow": cf}
        if ev is not None:
            cols["energy_value"] = ev
        name = _part_name(year, self._rank)
        atomic_write_npz(os.path.join(_dir(self.run_dir, "finance_series"), name), cols)
        self._record(year, os.path.join("finance_series", name))

    def write_finance_series(self, year: int, outs, prepared=None) -> None:
        # compact runs drop energy_value, the detail column and half the
        # surface's bytes; the cash-flow series, the surface's point, stays
        rows = self._local_fields(self._fin_fields(outs), self._fin_quant(),
                                  prepared=prepared,
                                  names=("cash_flow", "energy_value_pv_only"), year=year)
        self._write_fin_frame(year, rows[0], None if self.compact else rows[1])

    # --- state_hourly_agg (reference attachment_rate_functions.py:151) ---
    def write_state_hourly(self, year: int, hourly: np.ndarray) -> None:
        n_states = hourly.shape[0]
        self._check_state_names(n_states)
        names = self.state_names or [str(i) for i in range(n_states)]
        atomic_write_npz(
            os.path.join(_dir(self.run_dir, "state_hourly"), _part_name(year)),
            {"state": np.asarray(names, dtype=str),
             "year": np.full(n_states, int(year), np.int64),
             "net_load_mw": np.asarray(hourly, dtype=np.float32)})
        self._record(year, os.path.join("state_hourly", _part_name(year)))


def static_frame_from_table(table, states: Optional[Sequence[str]] = None
                            ) -> Dict[str, np.ndarray]:
    """The static per-agent columns (real agents only) the reference
    carries on every agent_outputs row but that never change year over
    year: agent_id, state_abbr and sector_abbr (fixed-width unicode),
    customers_in_bin and developable_agent_weight. Written once a run as
    ``agents.npz``, so a run directory is self-contained."""
    h = lambda t: t.detach().cpu().numpy()
    keep = h(table.mask) > 0
    st = h(table.state_idx)[keep]
    sec = h(table.sector_idx)[keep]
    dev = h(table.developable_agent_weight(table.customers_in_bin))[keep]
    state_abbr = (np.asarray(states, dtype=str)[st] if states is not None
                  else st.astype(str))
    return {
        "agent_id": h(table.agent_id)[keep],
        "state_abbr": state_abbr,
        "sector_abbr": np.asarray(SECTOR_ABBR, dtype=str)[sec],
        "customers_in_bin": h(table.customers_in_bin)[keep],
        "developable_agent_weight": dev,
    }


def _parts(run_dir: str, name: str) -> list:
    d = os.path.join(run_dir, name)
    parts = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".npz"))
    if not parts:
        raise FileNotFoundError(f"no .npz partitions under {d}")
    return parts


def load_surface(run_dir: str, name: str) -> Dict[str, np.ndarray]:
    """A surface's columns concatenated over the run's year partitions
    (in year order): ``{column: np.ndarray}``."""
    cols: Dict[str, list] = {}
    for p in _parts(run_dir, name):
        with np.load(p, allow_pickle=False) as z:
            for k in z.files:
                cols.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in cols.items()}


def frame_columns(cols: Dict[str, np.ndarray]) -> Dict[str, object]:
    """A surface's columns as the JAX package's frame holds them (to build
    a ``pandas.DataFrame`` from): 2-D columns as list columns (one array a
    row), unicode columns as ``str`` objects, the rest as they are."""
    data = {}
    for k, v in cols.items():
        if v.ndim > 1:
            data[k] = list(v)
        elif v.dtype.kind == "U":
            data[k] = v.astype(object)
        else:
            data[k] = v
    return data


def to_parquet(run_dir: str, out_dir: str) -> str:
    """Rewrite a port run directory into the JAX package's layout under
    ``out_dir``: ``<surface>/year=<Y>.parquet`` (zstd, list columns for
    the series), ``agents.parquet`` and ``meta.json``, so that
    ``dgen_tpu.io.export.load_surface`` and the reference-schema
    writeback read the run. A sweep's directory (``dgen_tpu_torch.
    sweep``) is rewritten a ``scenario=<label>/`` subdirectory at a time,
    with its ``sweep.json`` copied and an ensemble's ``quantiles.npz``
    written as ``quantiles.parquet``. CPU side: imports pandas (and
    pyarrow through it) here, never on the card path. Returns
    ``out_dir``."""
    import pandas as pd

    def frame(npz_path: str) -> "pd.DataFrame":
        with np.load(npz_path, allow_pickle=False) as z:
            return pd.DataFrame(frame_columns({k: z[k] for k in z.files}))

    os.makedirs(out_dir, exist_ok=True)
    for sub in sorted(os.listdir(run_dir)):
        if sub.startswith("scenario=") and os.path.isdir(os.path.join(run_dir, sub)):
            to_parquet(os.path.join(run_dir, sub), os.path.join(out_dir, sub))
    for name in ("sweep.json",):
        if os.path.exists(os.path.join(run_dir, name)):
            shutil.copyfile(os.path.join(run_dir, name), os.path.join(out_dir, name))
    quantiles = os.path.join(run_dir, "quantiles.npz")
    if os.path.exists(quantiles):
        df = frame(quantiles)
        atomic_write(os.path.join(out_dir, "quantiles.parquet"),
                     lambda tmp: df.to_parquet(tmp, compression=_PARQUET_COMPRESSION))
    for name in SURFACES:
        if not os.path.isdir(os.path.join(run_dir, name)):
            continue
        d = _dir(out_dir, name)
        for p in _parts(run_dir, name):
            stem = os.path.basename(p)[:-len(".npz")]
            df = frame(p)
            atomic_write(os.path.join(d, f"{stem}.parquet"),
                         lambda tmp: df.to_parquet(tmp, compression=_PARQUET_COMPRESSION))
    agents = os.path.join(run_dir, "agents.npz")
    if os.path.exists(agents):
        df = frame(agents)
        atomic_write(os.path.join(out_dir, "agents.parquet"),
                     lambda tmp: df.to_parquet(tmp, compression=_PARQUET_COMPRESSION))
    meta = os.path.join(run_dir, "meta.json")
    if os.path.exists(meta):
        shutil.copyfile(meta, os.path.join(out_dir, "meta.json"))
    return out_dir
