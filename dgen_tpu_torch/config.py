"""Run and scenario configuration, and the device rule of the port.

A copy of the settings of ``dgen_tpu/config.py`` that the model-year
path reads (the JAX package is never imported here: importing any of
its modules imports jax). ``ScenarioConfig`` is mirrored whole;
``RunConfig`` carries the run settings of the ported paths: the sizing
search's candidate count, the gated kernel paths (daylight compaction,
pack-once, the stream engine) and the narrow profile banks (bf16, int8).
Other knobs arrive with the slices that port them; the JAX package's
checks that tie the bank knobs to its differentiable twin do not apply
here (the twin is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

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

    #: candidates per refine round of the sizing search
    sizing_iters: int = 12
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

    def __post_init__(self) -> None:
        _check(4 <= self.sizing_iters <= 64, "sizing_iters out of range")


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
