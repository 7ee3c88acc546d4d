"""Run and scenario configuration, and the device rule of the port.

A copy of the settings of ``dgen_tpu/config.py`` that the model-year
path reads (the JAX package is never imported here: importing any of
its modules imports jax). ``ScenarioConfig`` is mirrored whole;
``RunConfig`` carries the run settings of the ported paths: the sizing
search's candidate count, the devices of a run and its state partition,
the gated kernel paths (daylight compaction,
pack-once, the stream engine), the narrow profile banks (bf16, int8),
the streaming agent chunk with its padding, the invariant harness, the
health sentinel, the host-I/O pipeline, load-time validation and
quarantine, the fault spec of the run supervisor, the differentiable
twin's smooth boundaries (``soft_boundaries``, ``soft_tau``) and the
run's ``seed``. ``ServeConfig`` is the serving stack's (buckets, queue,
HTTP, answer surface, result cache), with the JAX package's
``DGEN_TPU_SERVE_*`` switches and validation, and ``FleetConfig`` the
serving fleet's (replicas, breakers, shedding, drain, autoscaling), with
its ``DGEN_TPU_FLEET_*`` switches, and ``GangConfig`` the rank gang's
(ranks, liveness bounds, restarts, the shrink plan), with its
``DGEN_TPU_GANG_*`` switches. Other knobs arrive with the slices that
port them.

``RunConfig.from_env`` reads the JAX package's ``DGEN_TPU_*`` switches
of the ported fields, and refuses a switch that asks for a feature the
port does not have; ``DGEN_TPU_VALIDATE`` is read when a Simulation is
built (``RunConfig.validate_enabled``), ``DGEN_TPU_SENTINEL`` and
``DGEN_TPU_ASYNC_IO`` at run time (``RunConfig.sentinel_enabled``,
``RunConfig.async_io_enabled``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

SECTORS = ("res", "com", "ind")

#: payback grid of the max-market-share curves: 0.0..30.1 in 0.1 steps
PAYBACK_GRID_MAX = 30.1
PAYBACK_GRID_STEP = 0.1
PAYBACK_GRID_N = int(round(PAYBACK_GRID_MAX / PAYBACK_GRID_STEP)) + 1  # 302
PAYBACK_NEVER = 30.1

#: synthetic Bass-diffusion defaults (p, q, teq_yr1)
BASS_DEFAULTS = (0.0015, 0.35, 2.0)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Per-scenario settings (mirror of ``dgen_tpu.config.ScenarioConfig``)."""

    name: str = "default"
    start_year: int = 2014
    end_year: int = 2050
    year_step: int = 2
    sectors: Tuple[str, ...] = SECTORS
    economic_lifetime_yrs: int = 30
    anchor_years: Tuple[int, ...] = (2014, 2016, 2018)
    storage_enabled: bool = True
    annual_inflation: float = 0.025

    def __post_init__(self) -> None:
        _check(1990 <= self.start_year <= 2050, "start_year out of range")
        _check(self.start_year <= self.end_year <= 2050,
               "end_year must be in [start_year, 2050]")
        _check(self.year_step in (1, 2), "year_step must be 1 or 2")
        _check(all(s in SECTORS for s in self.sectors), "unknown sector")
        _check(1 <= self.economic_lifetime_yrs <= 50, "bad lifetime")
        _check(0.0 <= self.annual_inflation < 0.5, "bad inflation")

    @property
    def model_years(self) -> Sequence[int]:
        return list(range(self.start_year, self.end_year + 1, self.year_step))


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run settings the model-year path reads."""

    #: pad the agent axis to a multiple of this
    agent_pad_multiple: int = 128
    #: candidates per refine round of the sizing search
    sizing_iters: int = 12
    #: agent-axis chunk of the streaming year step (rows per chunk): the
    #: sizing search runs chunk by chunk, so the [chunk, 8760] hour
    #: streams bound the step's peak memory whatever the population.
    #: ``None`` (default) derives the chunk from the card's memory
    #: (models.simulation.auto_agent_chunk; 0 on the CPU); ``0`` runs the
    #: whole table at once; ``> 0`` fixes the rows of a chunk.
    agent_chunk: Optional[int] = None
    #: devices of the run (None: all it is given); a multi-rank run's
    #: ranks come from ``parallel.launch`` (one device a rank)
    n_devices: Optional[int] = None
    #: reorder agents so that states are shard-local on a multi-rank run
    #: (``parallel.partition``, the reference's per-state task binning);
    #: False splits the table into contiguous row blocks, and the market
    #: step gathers its group operands across ranks
    partition_by_state: bool = True
    #: check the carry and the outputs after every year
    #: (utils.invariants: schema, shapes, dtypes, finiteness; host sync)
    debug_invariants: bool = False
    #: daylight-compacted bill kernels (ops.layout.DaylightLayout): the
    #: sizing search's candidate kernels run only over the union daylight
    #: lanes of the generation bank (~half the hour axis for rooftop
    #: solar); night-hour bucket sums do not depend on the candidate and
    #: are added back exactly. Off by default: the full-hour path is the
    #: parity oracle; results agree to float32 re-association.
    daylight_compact: bool = False
    #: build the sizing search's candidate lanes ONCE per size_agents
    #: call (billkernels.PackedStreams) instead of once per bucket-sums
    #: engine call: one gather (and one night-sums pass under
    #: daylight_compact) per year instead of up to three. Off by default.
    pack_once: bool = False
    #: run the candidate kernels on the segment-streaming kernel
    #: (csrc/bucket_sums_stream.cu): the copy of month segment m + 1
    #: overlaps the sums over segment m, and compacted lanes whose load
    #: and gen are both zero are not summed. Under daylight_compact the
    #: layout is padded to uniform segments, as the JAX package pads it.
    #: Off by default. Its sums equal the month kernel's bit for bit. On
    #: an H100 it is ~25% faster than the month kernel on the gated
    #: path's uniform compacted lanes (whose pad lanes it skips) and on
    #: the signed launch (R = 25, full-hour lanes), and level with it on
    #: full-hour imports (PERF.md).
    stream_segments: bool = False
    #: tariff-clustered sizing (ops.tariffcluster): the compiled tariff
    #: corpus is split into structural clusters keyed by (metering, true
    #: periods, true tiers, demand presence), the agents are reordered
    #: cluster-major, and sizing runs once per cluster at the cluster's
    #: tight period and tier widths against its deduplicated rate bank;
    #: a net-metered cluster whose NEM gate never closes prices by the
    #: linear identity. Results keyed by agent_id are unchanged. Left off
    #: (with a log line) when rate switching is live: a base/switch
    #: tariff pair can straddle two clusters. Env: DGEN_TPU_CLUSTER.
    cluster_tariffs: bool = False
    #: store the hourly load / gen / wholesale profile banks in bfloat16:
    #: the gathered [N, 8760] streams of the sizing search are half the
    #: bytes, the kernels upcast them when read and sum in float32, and
    #: the candidate sums are stored in bfloat16 (billkernels
    #: _sums_out_dtype). Inputs round to ~3 significant digits; the
    #: dispatch loop, linear sums and hourly profiles price float32
    #: copies. Off by default; national curves stay within 2% of the
    #: float32 run (tests/test_torch_golden.py).
    bf16_banks: bool = False
    #: store the load and generation banks as int8 codes with per-row
    #: float32 scales (agents.quantize_rows): the candidate kernels read
    #: one byte per hour and fold the scales into the candidate scales
    #: (billkernels._quant_fold); the dispatch loop, linear sums, naep
    #: and hourly profiles price dequantized float32. Quantized after the
    #: daylight layout is built and before any bf16 conversion. Off by
    #: default; national curves stay within 2% of the float32 run.
    quant_banks: bool = False
    #: the numerical-health sentinel (models.health): per year, the
    #: nonfinite and out-of-bounds counts of the monitored outputs.
    #: None (default) = on unless the DGEN_TPU_SENTINEL kill switch says
    #: 0/false/off (``sentinel_enabled``); True/False set it outright.
    #: Breaches warn; see ``sentinel_escalate``.
    health_sentinel: Optional[bool] = None
    #: raise a sentinel breach as HealthBreachError instead of warning:
    #: the run supervisor's detect -> attribute -> quarantine -> resume
    #: loop rides this (``run_supervised`` turns None on, unless it is
    #: set False). None/False = warn only.
    sentinel_escalate: Optional[bool] = None
    #: the background host-I/O pipeline (io.hostio): result collection,
    #: RunExporter writes and checkpoint saves run on worker threads, the
    #: year's outputs copied to pinned host memory on a side CUDA stream,
    #: while the run loop dispatches the next year. None (default) = on
    #: unless the DGEN_TPU_ASYNC_IO kill switch says 0/false/off
    #: (``async_io_enabled``); False restores the serialized per-year
    #: path (the bit-exact parity oracle); True forces it on.
    #: debug_invariants always serializes.
    async_host_io: Optional[bool] = None
    #: load-time bad-data validation (resilience.quarantine): finiteness,
    #: range and reference checks over the agent table, the profile banks
    #: (int8 scale sidecars included) and the tariff bank at Simulation
    #: construction, on the tensors' device; malformed rows are
    #: quarantined (rewritten to inert padding, mask 0) with a reasoned
    #: report instead of poisoning their state. None (default) = on
    #: unless the DGEN_TPU_VALIDATE kill switch says 0/false/off
    #: (``validate_enabled``, read when a Simulation is built); clean
    #: inputs come back as the same objects, so a clean run launches what
    #: it launched before.
    validate_inputs: Optional[bool] = None
    #: stable agent ids quarantined by fiat at Simulation construction,
    #: on top of the validation's findings: the supervisor's sentinel
    #: escalation brings the attributed ids back through here
    quarantine_ids: Optional[Tuple[int, ...]] = None
    #: deterministic fault-injection spec (resilience.faults grammar,
    #: e.g. ``"ckpt_save@2;year_step@3:oom"``), installed by the run
    #: supervisor before its first attempt. None injects nothing; a plain
    #: Simulation.run ignores the field.
    faults: Optional[str] = None
    #: the differentiable twin (dgen_tpu_torch.grad): the objective's
    #: kinks (tier and TOU-bucket edges, the hard relu import/export
    #: splits, the payback rounding, the payback -> max-market-share snap)
    #: become softplus surrogates and straight-through gates of
    #: temperature ``soft_tau``, so sizing and the multi-year rollout take
    #: autograd. Off by default: the hard path is the exact oracle. Smooth
    #: runs price plain float32 full-hour streams with the plain
    #: differentiable sums (billkernels.plain_sums; no kernel has a soft
    #: form): no daylight_compact, bf16_banks, quant_banks, pack_once,
    #: stream_segments or cluster_tariffs. Env: DGEN_TPU_SOFT.
    soft_boundaries: bool = False
    #: smoothing temperature of soft_boundaries in the objective's own
    #: units (kW at the hourly import/export splits, kWh at the monthly
    #: tier edges). Env: DGEN_TPU_SOFT_TAU.
    soft_tau: float = 0.1
    #: the run's seed, as in the JAX package's RunConfig (nothing reads it
    #: there either; the synthetic worlds take their own seeds)
    seed: int = 0

    def __post_init__(self) -> None:
        _check(self.agent_pad_multiple >= 1, "bad pad multiple")
        _check(4 <= self.sizing_iters <= 64, "sizing_iters out of range")
        _check(self.agent_chunk is None or self.agent_chunk >= 0,
               "agent_chunk must be None (auto) or >= 0")
        _check(self.soft_tau > 0.0, "soft_tau must be > 0")
        if self.soft_boundaries:
            _check(
                not (self.daylight_compact or self.bf16_banks or self.quant_banks
                     or self.pack_once or self.stream_segments),
                "soft_boundaries requires the plain f32 full-hour path (no "
                "daylight_compact/bf16_banks/quant_banks/pack_once/"
                "stream_segments)",
            )
            _check(not self.cluster_tariffs,
                   "soft_boundaries requires the plain f32 full-hour path (no "
                   "cluster_tariffs)")
        if self.quarantine_ids is not None:
            _check(all(int(a) == a for a in self.quarantine_ids),
                   "quarantine_ids must be integer agent ids")

    @property
    def soft_tau_static(self) -> Optional[float]:
        """The temperature the year step runs under: ``soft_tau`` when
        ``soft_boundaries`` is set, else None (the hard path)."""
        return float(self.soft_tau) if self.soft_boundaries else None

    @property
    def validate_enabled(self) -> bool:
        """The resolved load-time validation decision: the explicit field
        when set, else on unless the ``DGEN_TPU_VALIDATE`` kill switch
        says 0/false/off (read when a Simulation is constructed)."""
        if self.validate_inputs is not None:
            return self.validate_inputs
        return os.environ.get("DGEN_TPU_VALIDATE", "") not in ("0", "false", "off")

    @property
    def sentinel_enabled(self) -> bool:
        """The resolved health-sentinel decision: the explicit field when
        set, else on unless ``DGEN_TPU_SENTINEL`` says 0/false/off (read
        at run time, so an operator can switch it off on a built
        config)."""
        if self.health_sentinel is not None:
            return self.health_sentinel
        return os.environ.get("DGEN_TPU_SENTINEL", "") not in ("0", "false", "off")

    @property
    def async_io_enabled(self) -> bool:
        """The resolved host-I/O pipeline decision: the explicit field
        when set, else on unless ``DGEN_TPU_ASYNC_IO`` says 0/false/off
        (read at run time, so an operator can switch a built config back
        to the serialized path)."""
        if self.async_host_io is not None:
            return self.async_host_io
        return os.environ.get("DGEN_TPU_ASYNC_IO", "") not in ("0", "false", "off")

    @classmethod
    def from_env(cls, **overrides) -> "RunConfig":
        """A RunConfig from the ``DGEN_TPU_*`` switches, as the JAX
        package's ``RunConfig.from_env`` reads them, ``overrides`` winning
        over the environment: ``DGEN_TPU_AGENT_CHUNK`` (rows),
        ``DGEN_TPU_DEBUG``, ``DGEN_TPU_DAYLIGHT``, ``DGEN_TPU_BF16_BANKS``,
        ``DGEN_TPU_QUANT_BANKS``, ``DGEN_TPU_PACK_ONCE``,
        ``DGEN_TPU_STREAM``, ``DGEN_TPU_CLUSTER`` (``cluster_tariffs``),
        ``DGEN_TPU_SOFT`` (``soft_boundaries``) and ``DGEN_TPU_SOFT_TAU``
        (``soft_tau``, a float) (a flag is on unless empty, "0" or
        "false").

        ``DGEN_TPU_DEVICES`` sets ``n_devices`` (the devices of a run, as
        the JAX package reads it; a multi-rank run takes its ranks from
        ``parallel.launch``). A switch that asks for a feature the port
        lacks raises ``NotImplementedError``: ``DGEN_TPU_GUARD`` on. ``DGEN_TPU_VALIDATE`` is read when a
        Simulation is built (``validate_enabled``); ``DGEN_TPU_FAULTS`` is not a field here:
        the run supervisor or ``resilience.faults.install_from_env``
        installs it, as in the JAX package. ``DGEN_TPU_SENTINEL`` and
        ``DGEN_TPU_ASYNC_IO`` are not baked in: their fields stay None, so
        the switches are read at run time."""
        env = os.environ

        def flag(name: str) -> bool:
            return env.get(name, "") not in ("", "0", "false")

        if "n_devices" not in overrides and env.get("DGEN_TPU_DEVICES"):
            overrides["n_devices"] = int(env["DGEN_TPU_DEVICES"])
        if flag("DGEN_TPU_GUARD"):
            raise NotImplementedError(
                f"DGEN_TPU_GUARD={env['DGEN_TPU_GUARD']}: guard_retrace is not ported")
        if "agent_chunk" not in overrides and env.get("DGEN_TPU_AGENT_CHUNK"):
            overrides["agent_chunk"] = int(env["DGEN_TPU_AGENT_CHUNK"])
        if "soft_tau" not in overrides and env.get("DGEN_TPU_SOFT_TAU"):
            overrides["soft_tau"] = float(env["DGEN_TPU_SOFT_TAU"])
        for field, name in (("debug_invariants", "DGEN_TPU_DEBUG"),
                            ("daylight_compact", "DGEN_TPU_DAYLIGHT"),
                            ("bf16_banks", "DGEN_TPU_BF16_BANKS"),
                            ("quant_banks", "DGEN_TPU_QUANT_BANKS"),
                            ("pack_once", "DGEN_TPU_PACK_ONCE"),
                            ("stream_segments", "DGEN_TPU_STREAM"),
                            ("cluster_tariffs", "DGEN_TPU_CLUSTER"),
                            ("soft_boundaries", "DGEN_TPU_SOFT")):
            if field not in overrides and flag(name):
                overrides[field] = True
        return cls(**overrides)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks for another. Raises when a CUDA device is asked for and there
    is none — the port never carries on on the CPU unasked.

    On a CUDA device it also pins float32 matrix products to full
    float32 (no TF32), so the plain tensor code around the kernels
    computes what the JAX package computes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Settings of the serving stack (:mod:`dgen_tpu_torch.serve`): the
    microbatcher's buckets and queue, the HTTP front-end, the answer
    surface and the result cache. Bucket sizes are powers of two, so the
    set of row counts a serving process launches its kernels at is
    fixed up front (``log2(max_batch / min_bucket) + 1`` buckets, all
    run once at warmup)."""

    #: largest microbatch (rows a query bucket sizes at once)
    max_batch: int = 64
    #: smallest padded bucket (1: a single agent runs alone)
    min_bucket: int = 1
    #: deadline flush: a queued request waits at most this long for
    #: co-batching before its (possibly underfull) bucket dispatches
    max_wait_ms: float = 5.0
    #: admission control: submissions beyond this many queued requests
    #: are refused with ``serve.QueueFullError`` (HTTP 503)
    max_queue: int = 256
    #: HTTP bind address; port 0 binds an ephemeral port (tests)
    host: str = "127.0.0.1"
    port: int = 8178
    #: run every bucket once before accepting traffic, so the kernel
    #: library is built and loaded before the first request
    warmup: bool = True
    #: per-request deadline of a handler on the batcher's future (504)
    request_timeout_s: float = 60.0
    #: per-connection socket timeout of a handler thread
    socket_timeout_s: float = 30.0
    #: precomputed answer-surface directory (``serve.surface``), mapped
    #: at boot and provenance-gated; None: engine path only
    surface_dir: Optional[str] = None
    #: exact result-cache directory (``serve.resultcache``); None: off
    result_cache_dir: Optional[str] = None
    #: result-cache entry bound (files), least recently used evicted
    result_cache_entries: int = 512

    def __post_init__(self) -> None:
        _check(_is_pow2(self.max_batch), "max_batch must be a power of two")
        _check(_is_pow2(self.min_bucket) and self.min_bucket <= self.max_batch,
               "min_bucket must be a power of two <= max_batch")
        _check(self.max_wait_ms >= 0.0, "max_wait_ms must be >= 0")
        _check(self.max_queue >= 1, "max_queue must be >= 1")
        _check(0 <= self.port <= 65535, "port out of range")
        _check(self.request_timeout_s > 0.0, "request_timeout_s must be > 0")
        _check(self.socket_timeout_s > 0.0, "socket_timeout_s must be > 0")
        _check(self.result_cache_entries >= 1,
               "result_cache_entries must be >= 1")

    @property
    def buckets(self) -> Tuple[int, ...]:
        """The bucket sizes, ascending (powers of two from min_bucket to
        max_batch)."""
        out = []
        b = self.min_bucket
        while b <= self.max_batch:
            out.append(b)
            b *= 2
        return tuple(out)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        """The JAX package's switches: DGEN_TPU_SERVE_MAX_BATCH, _WAIT_MS,
        _QUEUE, _HOST, _PORT, _WARMUP (0/false/off = off),
        _REQ_TIMEOUT_S, _SOCK_TIMEOUT_S, _SURFACE (answer-surface dir),
        _CACHE_DIR and _CACHE_ENTRIES (result cache); an explicit
        keyword wins over its switch."""
        env = os.environ.get
        for field, name, conv in (
                ("surface_dir", "SURFACE", str),
                ("result_cache_dir", "CACHE_DIR", str),
                ("result_cache_entries", "CACHE_ENTRIES", int),
                ("max_batch", "MAX_BATCH", int),
                ("max_wait_ms", "WAIT_MS", float),
                ("max_queue", "QUEUE", int),
                ("host", "HOST", str),
                ("port", "PORT", int),
                ("request_timeout_s", "REQ_TIMEOUT_S", float),
                ("socket_timeout_s", "SOCK_TIMEOUT_S", float)):
            raw = env(f"DGEN_TPU_SERVE_{name}")
            if field not in overrides and raw:
                overrides[field] = conv(raw)
        raw = env("DGEN_TPU_SERVE_WARMUP")
        if "warmup" not in overrides and raw:
            overrides["warmup"] = raw not in ("0", "false", "off")
        return cls(**overrides)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Settings of the serving fleet (:mod:`dgen_tpu_torch.serve.fleet`,
    :mod:`~dgen_tpu_torch.serve.front`, :mod:`~dgen_tpu_torch.serve.autoscale`):
    how many replicas, when a replica counts as routable, how the front's
    per-replica circuit breakers trip and recover, when the fleet sheds
    load, how a drain is bounded, and the autoscaler's bands. The JAX
    package's fields, defaults, validation and ``DGEN_TPU_FLEET_*``
    switches (:meth:`from_env`)."""

    #: replica processes the supervisor keeps alive
    n_replicas: int = 2
    #: front bind address (port 0: an ephemeral port)
    host: str = "127.0.0.1"
    port: int = 8177
    #: a spawned replica must reach READY (portfile written and /readyz
    #: green) within this wall, or it is killed and counted as a death
    boot_timeout_s: float = 180.0
    #: supervisor monitor cadence (liveness polls, restart scheduling)
    poll_interval_s: float = 0.2
    #: crash-loop breaker: more than this many deaths inside
    #: ``restart_window_s`` marks the replica FAILED (no more restarts)
    max_restarts: int = 5
    restart_window_s: float = 120.0
    #: front breaker: consecutive forward failures that OPEN it, and how
    #: long it stays open before one HALF_OPEN probe request
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1.0
    #: front -> replica forward deadline (connect and response)
    request_timeout_s: float = 30.0
    #: shed when the READY replicas' summed queue depth reaches this
    #: fraction of their summed queue capacity
    shed_queue_frac: float = 0.8
    #: Retry-After seconds of every 503 the front generates
    retry_after_s: float = 1.0
    #: the front's /metricz scrape cadence (the shed signal's freshness)
    metricz_interval_s: float = 0.5
    #: graceful drain bound
    drain_timeout_s: float = 30.0
    #: size the fleet between min_replicas and max_replicas from the
    #: aggregated /metricz pressure (``serve.autoscale.Autoscaler``)
    autoscale: bool = False
    #: autoscale bounds (n_replicas, the boot size, lies within them when
    #: autoscaling is on)
    min_replicas: int = 1
    max_replicas: int = 4
    #: scale up when the queue fraction or the batch occupancy reaches its
    #: threshold for scale_up_sustain_s
    scale_up_queue_frac: float = 0.25
    scale_up_occupancy: float = 0.75
    scale_up_sustain_s: float = 2.0
    #: scale down when both sit at or below their bound for
    #: scale_down_sustain_s (hysteresis: strictly below the up thresholds)
    scale_down_queue_frac: float = 0.02
    scale_down_occupancy: float = 0.25
    scale_down_sustain_s: float = 10.0
    #: least wall between any two scale actions
    scale_cooldown_s: float = 5.0
    #: autoscaler decision cadence
    scale_interval_s: float = 0.5

    def __post_init__(self) -> None:
        _check(self.n_replicas >= 1, "n_replicas must be >= 1")
        _check(self.min_replicas >= 1, "min_replicas must be >= 1")
        _check(self.max_replicas >= self.min_replicas,
               "max_replicas must be >= min_replicas")
        if self.autoscale:
            _check(self.min_replicas <= self.n_replicas <= self.max_replicas,
                   "with autoscale on, n_replicas (the boot size) must lie "
                   "within [min_replicas, max_replicas]")
        _check(0.0 < self.scale_up_queue_frac <= 1.0,
               "scale_up_queue_frac must be in (0, 1]")
        _check(0.0 <= self.scale_down_queue_frac < self.scale_up_queue_frac,
               "scale_down_queue_frac must be < scale_up_queue_frac (hysteresis)")
        _check(0.0 < self.scale_up_occupancy <= 1.0,
               "scale_up_occupancy must be in (0, 1]")
        _check(0.0 <= self.scale_down_occupancy < self.scale_up_occupancy,
               "scale_down_occupancy must be < scale_up_occupancy (hysteresis)")
        _check(self.scale_up_sustain_s >= 0, "scale_up_sustain_s must be >= 0")
        _check(self.scale_down_sustain_s >= 0, "scale_down_sustain_s must be >= 0")
        _check(self.scale_cooldown_s >= 0, "scale_cooldown_s must be >= 0")
        _check(self.scale_interval_s > 0, "scale_interval_s must be > 0")
        _check(0 <= self.port <= 65535, "port out of range")
        _check(self.boot_timeout_s > 0, "boot_timeout_s must be > 0")
        _check(self.poll_interval_s > 0, "poll_interval_s must be > 0")
        _check(self.max_restarts >= 0, "max_restarts must be >= 0")
        _check(self.restart_window_s > 0, "restart_window_s must be > 0")
        _check(self.breaker_failures >= 1, "breaker_failures must be >= 1")
        _check(self.breaker_cooldown_s >= 0, "breaker_cooldown_s must be >= 0")
        _check(self.request_timeout_s > 0, "request_timeout_s must be > 0")
        _check(0.0 < self.shed_queue_frac <= 1.0, "shed_queue_frac must be in (0, 1]")
        _check(self.retry_after_s >= 0, "retry_after_s must be >= 0")
        _check(self.metricz_interval_s > 0, "metricz_interval_s must be > 0")
        _check(self.drain_timeout_s > 0, "drain_timeout_s must be > 0")

    @classmethod
    def from_env(cls, **overrides) -> "FleetConfig":
        """The JAX package's switches: DGEN_TPU_FLEET_REPLICAS, _HOST, _PORT,
        _BOOT_TIMEOUT_S, _MAX_RESTARTS, _BREAKER_FAILURES,
        _BREAKER_COOLDOWN_S, _REQ_TIMEOUT_S, _SHED_FRAC, _RETRY_AFTER_S,
        _DRAIN_TIMEOUT_S, _AUTOSCALE (0/false/off = off), _MIN_REPLICAS,
        _MAX_REPLICAS, _SCALE_UP_QUEUE_FRAC, _SCALE_UP_SUSTAIN_S,
        _SCALE_DOWN_SUSTAIN_S, _SCALE_COOLDOWN_S; an explicit keyword wins
        over its switch."""
        env = os.environ.get
        raw = env("DGEN_TPU_FLEET_AUTOSCALE")
        if "autoscale" not in overrides and raw:
            overrides["autoscale"] = raw not in ("0", "false", "off")
        for field, name, conv in (
                ("n_replicas", "REPLICAS", int),
                ("host", "HOST", str),
                ("port", "PORT", int),
                ("boot_timeout_s", "BOOT_TIMEOUT_S", float),
                ("max_restarts", "MAX_RESTARTS", int),
                ("breaker_failures", "BREAKER_FAILURES", int),
                ("breaker_cooldown_s", "BREAKER_COOLDOWN_S", float),
                ("request_timeout_s", "REQ_TIMEOUT_S", float),
                ("shed_queue_frac", "SHED_FRAC", float),
                ("retry_after_s", "RETRY_AFTER_S", float),
                ("drain_timeout_s", "DRAIN_TIMEOUT_S", float),
                ("min_replicas", "MIN_REPLICAS", int),
                ("max_replicas", "MAX_REPLICAS", int),
                ("scale_up_queue_frac", "SCALE_UP_QUEUE_FRAC", float),
                ("scale_up_sustain_s", "SCALE_UP_SUSTAIN_S", float),
                ("scale_down_sustain_s", "SCALE_DOWN_SUSTAIN_S", float),
                ("scale_cooldown_s", "SCALE_COOLDOWN_S", float)):
            raw = env(f"DGEN_TPU_FLEET_{name}")
            if field not in overrides and raw:
                overrides[field] = conv(raw)
        return cls(**overrides)


@dataclasses.dataclass(frozen=True)
class GangConfig:
    """Settings of the rank gang's supervisor
    (:mod:`dgen_tpu_torch.resilience.gang`): how many rank processes a
    multi-rank run starts, when a rank counts as stalled, how many
    restarts of the whole gang the crash-loop breaker allows, and the
    shrink plan a lost rank falls back to. Env prefix
    ``DGEN_TPU_GANG_*`` (:meth:`from_env`). The fields and their checks
    are the JAX package's; in the port a process is one rank, so:

    * ``n_processes``: ranks (world size, ``DGEN_NUM_PROCESSES``);
    * ``devices_per_process``: ranks per host, the second axis of
      ``parallel.mesh.default_mesh_shape`` (the supervisor hands it to
      every rank as ``DGEN_CPU_DEVICES``); ``total_devices``, when set,
      overrides it at each launch as ``total_devices / n_processes``;
    * ``platform``: the ranks' device, ``"cuda"`` (the default: ranks
      on the host's cards, several sharing one where there are more
      ranks than cards) or ``"cpu"`` (gloo); ``""`` leaves it to the
      worker's own ``DGEN_PLATFORM``.

    A multi-rank run is all-or-nothing: one dead or stalled rank leaves
    its peers at their next collective, so recovery tears the whole gang
    down and relaunches it from the manifest frontier."""

    #: rank processes of the gang
    n_processes: int = 2
    #: ranks per host (the mesh's second axis); ``total_devices`` (when
    #: set and divisible) overrides it per launch
    devices_per_process: int = 1
    total_devices: Optional[int] = None
    #: the ranks' device: "cuda", "cpu", or "" (the worker's own)
    platform: str = "cuda"
    #: a freshly spawned gang must heartbeat its first completed year
    #: (boot, process group, world build, first year) within this wall
    boot_timeout_s: float = 600.0
    #: once a rank has heartbeat a year, a heartbeat older than this
    #: marks it stalled; a floor: the supervisor scales the live bound to
    #: GangSupervisor.STALL_GRACE_FACTOR x the slowest year-over-year gap
    stall_timeout_s: float = 120.0
    #: supervisor monitor cadence
    poll_interval_s: float = 0.2
    #: crash-loop breaker: more than this many gang deaths inside
    #: ``restart_window_s`` stop restarts at the current rank count (the
    #: shrink plan, if any, then takes over)
    max_restarts: int = 3
    restart_window_s: float = 600.0
    #: rank counts to drop to, in order, when the breaker trips: the run
    #: resumes from the manifest frontier at P' ranks instead of dying
    shrink_plan: Tuple[int, ...] = ()
    #: SIGTERM drain bound: the ranks get this long to agree on a save
    #: year and exit before the supervisor kills them
    drain_timeout_s: float = 60.0
    #: rendezvous host (the ranks are children of the supervisor)
    coordinator_host: str = "127.0.0.1"

    def __post_init__(self) -> None:
        _check(self.n_processes >= 1, "n_processes must be >= 1")
        _check(self.devices_per_process >= 1, "devices_per_process must be >= 1")
        _check(self.total_devices is None or self.total_devices >= 1,
               "total_devices must be None or >= 1")
        _check(self.platform in ("", "cpu", "cuda"),
               "platform must be 'cuda', 'cpu' or ''")
        _check(self.boot_timeout_s > 0, "boot_timeout_s must be > 0")
        _check(self.stall_timeout_s > 0, "stall_timeout_s must be > 0")
        _check(self.poll_interval_s > 0, "poll_interval_s must be > 0")
        _check(self.max_restarts >= 0, "max_restarts must be >= 0")
        _check(self.restart_window_s > 0, "restart_window_s must be > 0")
        plan = self.shrink_plan
        _check(all(1 <= p < self.n_processes for p in plan)
               and all(a > b for a, b in zip(plan, plan[1:])),
               "shrink_plan must be strictly decreasing process counts "
               "below n_processes")
        if self.total_devices is not None:
            # a plan entry that does not divide total_devices would fall
            # back to devices_per_process and change the grid mid-run:
            # fail at construction, not at the relaunch that needed it
            _check(all(self.total_devices % p == 0 for p in (self.n_processes, *plan)),
                   "total_devices must divide evenly at n_processes and every "
                   "shrink_plan entry (the global mesh size must stay constant "
                   "through an elastic shrink)")
        _check(self.drain_timeout_s > 0, "drain_timeout_s must be > 0")

    def devices_for(self, n_processes: int) -> int:
        """Ranks per host for a launch at ``n_processes`` ranks:
        ``total_devices`` split evenly when set and divisible, else
        ``devices_per_process``."""
        total = self.total_devices
        if total is not None and total % n_processes == 0:
            return total // n_processes
        return self.devices_per_process

    @classmethod
    def from_env(cls, **overrides) -> "GangConfig":
        """The JAX package's switches: DGEN_TPU_GANG_PROCESSES,
        _DEVICES_PER_PROCESS, _TOTAL_DEVICES, _PLATFORM, _BOOT_TIMEOUT_S,
        _STALL_TIMEOUT_S, _MAX_RESTARTS, _SHRINK_PLAN (a comma list, e.g.
        "2,1"), _DRAIN_TIMEOUT_S; an explicit keyword wins over its
        switch."""
        env = os.environ.get
        for field, name, conv in (
                ("n_processes", "PROCESSES", int),
                ("devices_per_process", "DEVICES_PER_PROCESS", int),
                ("total_devices", "TOTAL_DEVICES", int),
                ("platform", "PLATFORM", str),
                ("boot_timeout_s", "BOOT_TIMEOUT_S", float),
                ("stall_timeout_s", "STALL_TIMEOUT_S", float),
                ("max_restarts", "MAX_RESTARTS", int),
                ("drain_timeout_s", "DRAIN_TIMEOUT_S", float)):
            raw = env(f"DGEN_TPU_GANG_{name}")
            if field not in overrides and raw:
                overrides[field] = conv(raw)
        raw = env("DGEN_TPU_GANG_SHRINK_PLAN")
        if "shrink_plan" not in overrides and raw:
            overrides["shrink_plan"] = tuple(int(p) for p in raw.split(",") if p.strip())
        return cls(**overrides)
