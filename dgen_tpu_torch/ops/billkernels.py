"""Bucket-sums engines of the sizing search and the bills built from
them: the counterpart of ``dgen_tpu/ops/billpallas.py``.

For every agent and R net-load scales ``s`` the sizing search needs
reductions over the 8760 hours of ``net = load - s * gen``:

  * signed (month x TOU-period) sums      -> net-metering bills
  * positive-part (import) bucket sums    -> net-billing import charges
  * sell-rate-weighted sums               -> net-billing export credit

Signed sums are linear in ``s`` and the export credit is linear given
the import sums, so the search only ever needs the import reductions
(:func:`import_sums`, :func:`import_sums_pair`); the battery forward run
needs the full set (:func:`bucket_sums`). Bucket ids are month-major
(``month * P + period``, ``P <= 10``); the period is ``bucket_id % P``.

Engines (``impl``):

  * ``"auto"``: the month kernel (``csrc/bucket_sums.cu``);
  * ``"stream"``: the segment-streaming kernel
    (``csrc/bucket_sums_stream.cu``); the pair stays on the pair kernel;
  * ``"dot"``: the one-hot tensor-core kernel (``csrc/bucket_sums_dot.cu``),
    full-hour only: it ignores a layout and refuses packed streams; the
    pair runs as two single-tariff passes.

The month and stream kernels read ``[N, L]`` lanes with 13 month
offsets (:mod:`dgen_tpu_torch.ops.layout`): the plain 8760-hour order,
or a daylight-compacted layout whose night-hour sums (which do not
depend on ``s``) are added after the kernel. :class:`PackedStreams`
holds those lanes built once per sizing call (``RunConfig.pack_once``).

On a CUDA tensor every engine launches its kernel or raises; on a CPU
tensor it runs the kernel's plain PyTorch version (the twin of the JAX
package's ``_sums_xla``). Each kernel wrapper counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from dgen_tpu_torch.ops.bill import AgentTariff, hour_month, monthly_period_sums
from dgen_tpu_torch.ops.layout import FULL_OFFSETS, DaylightLayout
from dgen_tpu_torch.ops.tariff import HOURS, MONTHS, NET_BILLING

#: most TOU periods a tariff bank may carry (12 * 10 buckets)
MAX_PERIODS = 10

#: engine choices of the entries below
IMPLS = ("auto", "stream", "dot")

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"month": 0, "month_signed": 0, "month_pair": 0, "stream": 0,
            "stream_signed": 0, "dot": 0, "dot_signed": 0,
            # the micro-benchmark's variants (ops/microkernels.py)
            "monthmask": 0, "monthmask_g": 0, "variant": 0, "monthdot": 0}

#: when a dict, each kernel wrapper keeps the arguments of its first
#: launch there under its :data:`LAUNCHES` key (to check and time a
#: kernel on the operands a real run gave it)
CAPTURE: dict | None = None

#: bytes of one [N, rc, L] float32 temporary the plain versions allow
_PLAIN_CHUNK_BYTES = 1 << 28


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_buckets(n_buckets: int) -> int:
    if n_buckets % MONTHS or not 1 <= n_buckets // MONTHS <= MAX_PERIODS:
        raise ValueError(
            f"{n_buckets} buckets is not 12 x n_periods with 1 <= n_periods "
            f"<= {MAX_PERIODS}"
        )
    return n_buckets // MONTHS


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' reference on the card)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lane_month_onehot(offsets: tuple, device: torch.device) -> torch.Tensor:
    """[L, 12] float32 lane -> month one-hot of a lane layout."""
    month_of_lane = np.repeat(np.arange(MONTHS), np.diff(offsets))
    return torch.from_numpy(np.eye(MONTHS, dtype=np.float32)[month_of_lane]).to(device)


def _bucketize(x: torch.Tensor, masks: list, onehot: torch.Tensor) -> torch.Tensor:
    """[N, rc, L] -> [N, rc, 12 * P] month-major bucket sums."""
    cols = [(x * m[:, None, :]) @ onehot for m in masks]
    return torch.stack(cols, dim=-1).reshape(x.shape[0], x.shape[1], -1)


def _sums_buffers(n: int, r: int, n_periods: int, with_signed: bool,
                  device) -> list:
    """[imports [N, R, 12P], imp_sell [N, R], signed, sgn_sell] float32
    buffers; the signed pair is None unless ``with_signed``."""
    f32 = dict(dtype=torch.float32, device=device)

    def sums_and_sell():
        return [torch.empty((n, r, MONTHS * n_periods), **f32),
                torch.empty((n, r), **f32)]

    return sums_and_sell() + (sums_and_sell() if with_signed else [None, None])


def _scale_chunk(n: int, lanes: int) -> int:
    return max(1, _PLAIN_CHUNK_BYTES // max(1, n * lanes * 4))


def month_sums_plain(load, gen, sell, period, scales, offsets, n_periods: int,
                     with_signed: bool):
    """Plain version of the month and stream kernels over ``[N, L]``
    lanes with month ``m`` in ``[offsets[m], offsets[m + 1])``:
    (imports [N, R, 12P], imp_sell [N, R]) and, when ``with_signed``,
    also (signed, sgn_sell). Loops over chunks of scales with per-period
    masks against the lane-month one-hot."""
    n, r = scales.shape
    masks = [(period == p).to(torch.float32) for p in range(n_periods)]
    onehot = _lane_month_onehot(tuple(offsets), load.device)
    imp, imp_sell, sgn, sgn_sell = _sums_buffers(n, r, n_periods, with_signed,
                                                 load.device)
    rc = _scale_chunk(n, load.shape[1])
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        net = load[:, None, :] - s[:, :, None] * gen[:, None, :]
        pos = torch.clamp_min(net, 0.0)
        imp[:, r0:r0 + rc] = _bucketize(pos, masks, onehot)
        imp_sell[:, r0:r0 + rc] = (pos * sell[:, None, :]).sum(dim=2)
        if with_signed:
            sgn[:, r0:r0 + rc] = _bucketize(net, masks, onehot)
            sgn_sell[:, r0:r0 + rc] = (net * sell[:, None, :]).sum(dim=2)
    if with_signed:
        return imp, imp_sell, sgn, sgn_sell
    return imp, imp_sell


def month_pair_sums_plain(load, gen, sell_a, period_a, sell_b, period_b,
                          scales, offsets, n_periods: int):
    """Plain version of the pair kernel: (imports_a, imp_sell_a,
    imports_b, imp_sell_b) over one shared relu(net) on ``[N, L]``
    lanes."""
    n, r = scales.shape
    onehot = _lane_month_onehot(tuple(offsets), load.device)
    masks_a = [(period_a == p).to(torch.float32) for p in range(n_periods)]
    masks_b = [(period_b == p).to(torch.float32) for p in range(n_periods)]
    out = _sums_buffers(n, r, n_periods, True, load.device)
    rc = _scale_chunk(n, load.shape[1])
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        pos = torch.clamp_min(load[:, None, :] - s[:, :, None] * gen[:, None, :], 0.0)
        out[0][:, r0:r0 + rc] = _bucketize(pos, masks_a, onehot)
        out[1][:, r0:r0 + rc] = (pos * sell_a[:, None, :]).sum(dim=2)
        out[2][:, r0:r0 + rc] = _bucketize(pos, masks_b, onehot)
        out[3][:, r0:r0 + rc] = (pos * sell_b[:, None, :]).sum(dim=2)
    return tuple(out)


def dot_sums_plain(load, gen, sell, bucket_id, scales, n_periods: int,
                   with_signed: bool):
    """Plain version of the dot kernel: per chunk of hours, the one-hot
    bucket matrix M [N, Hc, 12P + 1] (sell rate in the last column) and
    ``relu(net) @ M`` (and ``net @ M``). Outputs as
    :func:`month_sums_plain`."""
    n, r = scales.shape
    nb = MONTHS * n_periods
    f32 = dict(dtype=torch.float32, device=load.device)
    acc_i = torch.zeros((n, r, nb + 1), **f32)
    acc_s = torch.zeros((n, r, nb + 1), **f32) if with_signed else None
    hc = min(HOURS, _scale_chunk(n, r))
    for h0 in range(0, load.shape[1], hc):
        h1 = h0 + hc
        m = torch.zeros((n, bucket_id[:, h0:h1].shape[1], nb + 1), **f32)
        m.scatter_(2, bucket_id[:, h0:h1, None].long(), 1.0)
        m[:, :, nb] = sell[:, h0:h1]
        net = load[:, None, h0:h1] - scales[:, :, None] * gen[:, None, h0:h1]
        acc_i += torch.bmm(torch.clamp_min(net, 0.0), m)
        if with_signed:
            acc_s += torch.bmm(net, m)
    out = (acc_i[..., :nb].contiguous(), acc_i[..., nb].contiguous())
    if with_signed:
        out += (acc_s[..., :nb].contiguous(), acc_s[..., nb].contiguous())
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_inputs(streams, ints, scales, lanes: int) -> tuple[int, int]:
    n, r = scales.shape
    dev = scales.device
    for name, t, dtype, shape in (
        [("stream", t, torch.float32, (n, lanes)) for t in streams]
        + [("period or bucket ids", t, torch.int32, (n, lanes)) for t in ints]
        + [("scales", scales, torch.float32, (n, r))]
    ):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, scales on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, r


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _offsets_arg(offsets, n_lanes: int):
    if len(offsets) != MONTHS + 1 or offsets[-1] != n_lanes:
        raise ValueError(f"month offsets {tuple(offsets)} do not end at the "
                         f"streams' {n_lanes} lanes")
    return (ctypes.c_int * (MONTHS + 1))(*(int(o) for o in offsets))


def _launch(fn_name: str, scales, *c_args) -> None:
    """Calls the library's C launcher on the current stream of the
    device of ``scales``; raises if the launch was refused."""
    from dgen_tpu_torch.ops import _build

    with torch.cuda.device(scales.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), fn_name)(*c_args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: CUDA error {rc} (1 = an argument the "
            "kernel does not take: shape, month offsets or alignment)")


def _count(key: str, args: tuple) -> None:
    LAUNCHES[key] += 1
    if CAPTURE is not None:
        CAPTURE.setdefault(key, args)


def _lane_sums(fn_name: str, key: str, load, gen, sell, period, scales,
               offsets, n_periods: int, with_signed: bool):
    n, r = _check_kernel_inputs((load, gen, sell), (period,), scales, load.shape[1])
    out = _sums_buffers(n, r, n_periods, with_signed, scales.device)
    if n and r:
        _launch(fn_name, scales, _ptr(load), _ptr(gen), _ptr(sell), _ptr(period),
                _ptr(scales), _offsets_arg(offsets, load.shape[1]),
                *(_ptr(o) for o in out), n, r, load.shape[1], n_periods,
                int(with_signed))
        _count(key + ("_signed" if with_signed else ""),
               (load, gen, sell, period, scales, offsets, n_periods, with_signed))
    return tuple(out if with_signed else out[:2])


def month_sums(load, gen, sell, period, scales, offsets, n_periods: int,
               with_signed: bool):
    """Month bucket sums over lanes (see :func:`month_sums_plain` for the
    outputs): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU one."""
    if scales.device.type == "cpu":
        return month_sums_plain(load, gen, sell, period, scales, offsets,
                                n_periods, with_signed)
    return _lane_sums("bucket_sums_month", "month", load, gen, sell, period,
                      scales, offsets, n_periods, with_signed)


def stream_sums(load, gen, sell, period, scales, offsets, n_periods: int,
                with_signed: bool):
    """The month kernel's function on the segment-streaming kernel: the
    CUDA kernel on a CUDA tensor, :func:`month_sums_plain` on a CPU
    one."""
    if scales.device.type == "cpu":
        return month_sums_plain(load, gen, sell, period, scales, offsets,
                                n_periods, with_signed)
    return _lane_sums("bucket_sums_stream", "stream", load, gen, sell, period,
                      scales, offsets, n_periods, with_signed)


def month_pair_sums(load, gen, sell_a, period_a, sell_b, period_b, scales,
                    offsets, n_periods: int):
    """Pair bucket sums over lanes (see :func:`month_pair_sums_plain`):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU one."""
    if scales.device.type == "cpu":
        return month_pair_sums_plain(load, gen, sell_a, period_a, sell_b,
                                     period_b, scales, offsets, n_periods)
    n, r = _check_kernel_inputs((load, gen, sell_a, sell_b), (period_a, period_b),
                                scales, load.shape[1])
    out = tuple(_sums_buffers(n, r, n_periods, True, scales.device))
    if n and r:
        _launch("bucket_sums_month_pair", scales, _ptr(load), _ptr(gen),
                _ptr(sell_a), _ptr(period_a), _ptr(sell_b), _ptr(period_b),
                _ptr(scales), _offsets_arg(offsets, load.shape[1]),
                *(_ptr(o) for o in out), n, r, load.shape[1], n_periods)
        _count("month_pair", (load, gen, sell_a, period_a, sell_b, period_b,
                              scales, offsets, n_periods))
    return out


def dot_sums(load, gen, sell, bucket_id, scales, n_periods: int,
             with_signed: bool):
    """Bucket sums on the one-hot tensor-core kernel over full-hour
    streams and bucket ids (see :func:`dot_sums_plain`): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU one."""
    if scales.device.type == "cpu":
        return dot_sums_plain(load, gen, sell, bucket_id, scales, n_periods,
                              with_signed)
    n, r = _check_kernel_inputs((load, gen, sell), (bucket_id,), scales, HOURS)
    out = _sums_buffers(n, r, n_periods, with_signed, scales.device)
    if n and r:
        _launch("bucket_sums_dot", scales, _ptr(load), _ptr(gen), _ptr(sell),
                _ptr(bucket_id), _ptr(scales), *(_ptr(o) for o in out), n, r,
                HOURS, n_periods, int(with_signed))
        _count("dot_signed" if with_signed else "dot",
               (load, gen, sell, bucket_id, scales, n_periods, with_signed))
    return tuple(out if with_signed else out[:2])


# ---------------------------------------------------------------------------
# Lanes, night sums and packed streams
# ---------------------------------------------------------------------------

def _check_ids(*bucket_ids) -> None:
    """Bucket ids are int32, as the kernels read them (None = not given)."""
    for b in bucket_ids:
        if b is not None and b.dtype != torch.int32:
            raise TypeError(f"bucket ids must be torch.int32, got {b.dtype}")


def _periods(bucket_id: torch.Tensor, n_periods: int) -> torch.Tensor:
    return bucket_id % n_periods


def _offsets(layout: Optional[DaylightLayout]) -> tuple:
    return FULL_OFFSETS if layout is None else layout.offsets


def _to_lanes(layout: Optional[DaylightLayout], arrays) -> list:
    """``[N, 8760]`` streams -> the layout's ``[N, L]`` lanes: the plain
    order itself for the full-hour layout, else the compacted gather with
    float lanes zeroed past each month's hour count."""
    if layout is None:
        return [a.contiguous() for a in arrays]
    idx, valid, _ = layout.device_maps(arrays[0].device)
    return [a.index_select(1, idx) if a.dtype == torch.int32
            else a.index_select(1, idx) * valid for a in arrays]


def night_sums(load, sell, bucket_id, night, n_periods: int, with_signed: bool):
    """Scale-independent bucket sums of the night hours (``night`` [8760]
    is 1 where no profile generates): there ``relu(load - s * gen) ==
    relu(load)`` and the signed net is ``load`` for every scale. Returns
    (imports, signed-or-None), each a pair (buckets [N, 12P], sell sum
    [N])."""
    n = load.shape[0]
    hour_period = _periods(bucket_id, n_periods)

    def sums(x):
        return (monthly_period_sums(x, hour_period, n_periods).reshape(n, -1),
                (x * sell).sum(dim=1))

    load_n = load * night[None, :]
    imp = sums(torch.clamp_min(load_n, 0.0))
    return imp, (sums(load_n) if with_signed else None)


@dataclasses.dataclass(frozen=True)
class PackedStreams:
    """Lanes of the candidate kernels, built once per sizing call
    (``RunConfig.pack_once``) for the layout later passed with them:
    ``[N, L]`` load, gen, sell and ``bucket % P`` period lanes, and under a
    compacted layout the night import sums. ``sell_b``/``period_b``/
    ``night_imp_b``: the second tariff structure of a rate-switch
    population, else None."""

    load: torch.Tensor
    gen: torch.Tensor
    sell: torch.Tensor
    period: torch.Tensor
    night_imp: Optional[tuple] = None
    sell_b: Optional[torch.Tensor] = None
    period_b: Optional[torch.Tensor] = None
    night_imp_b: Optional[tuple] = None


def pack_streams(load, gen, sell, bucket_id, n_buckets: int,
                 layout: Optional[DaylightLayout] = None, sell_b=None,
                 bucket_b=None) -> PackedStreams:
    """The pack-once lanes for ``layout`` (None = full-hour)."""
    n_periods = _check_buckets(n_buckets)
    _check_ids(bucket_id, bucket_b)
    arrays = [load, gen, sell, _periods(bucket_id, n_periods)]
    if sell_b is not None:
        arrays += [sell_b, _periods(bucket_b, n_periods)]
    lanes = _to_lanes(layout, arrays)
    night_imp = night_imp_b = None
    if layout is not None:
        night = layout.device_maps(load.device)[2]
        night_imp, _ = night_sums(load, sell, bucket_id, night, n_periods, False)
        if sell_b is not None:
            night_imp_b, _ = night_sums(load, sell_b, bucket_b, night, n_periods,
                                        False)
    return PackedStreams(
        load=lanes[0], gen=lanes[1], sell=lanes[2], period=lanes[3],
        night_imp=night_imp,
        sell_b=lanes[4] if sell_b is not None else None,
        period_b=lanes[5] if sell_b is not None else None,
        night_imp_b=night_imp_b,
    )


def _prep_positional(load, gen, sell, bucket_id, n_periods: int,
                     layout: Optional[DaylightLayout],
                     packed: Optional[PackedStreams]) -> list:
    """(load, gen, sell, period) lanes of one engine call: a pack's
    (checked against the layout's lane count; a raw ``gen`` beside a
    full-hour pack is the battery run's fresh stream), else gathered
    now."""
    n_lanes = HOURS if layout is None else layout.n_lanes
    if packed is None:
        return _to_lanes(layout, (load, gen, sell, _periods(bucket_id, n_periods)))
    if packed.load.shape[-1] != n_lanes:
        raise ValueError(
            f"packed streams carry {packed.load.shape[-1]} lanes but the "
            f"engine layout expects {n_lanes}; build them with "
            "pack_streams(..., layout=<the same layout>)")
    if gen is None:
        gen_l = packed.gen
    elif layout is not None:
        raise ValueError("a fresh gen stream cannot ride a daylight-compacted "
                         "pack (battery output is nonzero at night); price it "
                         "full-hour")
    else:
        gen_l = gen.contiguous()
    return [packed.load, gen_l, packed.sell, packed.period]


def _night_for(load, sell, bucket_id, layout, n_periods: int, with_signed: bool,
               packed):
    """(night imports, night signed) to add back, from a pack where it
    carries them."""
    if layout is None:
        return None, None
    if packed is not None:
        if with_signed:
            raise ValueError("packed streams carry import night sums only")
        return packed.night_imp, None
    night = layout.device_maps(load.device)[2]
    return night_sums(load, sell, bucket_id, night, n_periods, with_signed)


def _add_night(sums, sell_sum, night) -> tuple:
    if night is None:
        return sums, sell_sum
    return sums + night[0][:, None, :], sell_sum + night[1][:, None]


def _reject_packed_for_dot(packed) -> None:
    if packed is not None:
        raise ValueError("the dot engine is full-hour and does not consume "
                         "packed streams")


# ---------------------------------------------------------------------------
# Engine entries
# ---------------------------------------------------------------------------

def import_sums(load, gen, sell, bucket_id, scales, n_buckets: int,
                impl: str = "auto", layout: Optional[DaylightLayout] = None,
                packed: Optional[PackedStreams] = None):
    """(imports [N, R, B], imp_sell [N, R]): positive-part bucket sums
    and the sell-weighted positive-part sum for R net-load scales.

    ``layout``: a :class:`DaylightLayout` under which the kernel runs the
    compacted lanes only and the night sums are added back (valid where
    ``gen`` is zero off-daylight); totals cover all hours either way.
    ``packed``: lanes from :func:`pack_streams` for the same layout (the
    raw streams may then be None)."""
    n_periods = _check_buckets(n_buckets)
    _check_impl(impl)
    _check_ids(bucket_id)
    if impl == "dot":
        _reject_packed_for_dot(packed)
        return dot_sums(load, gen, sell, bucket_id, scales, n_periods, False)
    engine = stream_sums if impl == "stream" else month_sums
    lanes = _prep_positional(load, gen, sell, bucket_id, n_periods, layout, packed)
    imp, imp_sell = engine(*lanes, scales, _offsets(layout), n_periods, False)
    night_i, _ = _night_for(load, sell, bucket_id, layout, n_periods, False, packed)
    return _add_night(imp, imp_sell, night_i)


def import_sums_pair(load, gen, sell_a, bucket_a, sell_b, bucket_b, scales,
                     n_buckets: int, impl: str = "auto",
                     layout: Optional[DaylightLayout] = None,
                     packed: Optional[PackedStreams] = None):
    """(imports_a, imp_sell_a, imports_b, imp_sell_b): the rate-switch
    search's two tariff structures (switched, original) priced over ONE
    shared ``relu(load - s * gen)``, on the pair kernel under ``"auto"``
    and ``"stream"``; ``layout``/``packed`` as in :func:`import_sums` (a
    pack built with ``sell_b``/``bucket_b`` carries both)."""
    n_periods = _check_buckets(n_buckets)
    _check_impl(impl)
    _check_ids(bucket_a, bucket_b)
    if impl == "dot":
        _reject_packed_for_dot(packed)
        return (dot_sums(load, gen, sell_a, bucket_a, scales, n_periods, False)
                + dot_sums(load, gen, sell_b, bucket_b, scales, n_periods, False))
    if packed is not None:
        lanes = _prep_positional(load, gen, sell_a, bucket_a, n_periods, layout,
                                 packed) + [packed.sell_b, packed.period_b]
        night_a, night_b = packed.night_imp, packed.night_imp_b
    else:
        lanes = _to_lanes(layout, (load, gen, sell_a, _periods(bucket_a, n_periods),
                                   sell_b, _periods(bucket_b, n_periods)))
        night_a, _ = _night_for(load, sell_a, bucket_a, layout, n_periods, False, None)
        night_b, _ = _night_for(load, sell_b, bucket_b, layout, n_periods, False, None)
    out = month_pair_sums(*lanes, scales, _offsets(layout), n_periods)
    return _add_night(out[0], out[1], night_a) + _add_night(out[2], out[3], night_b)


def bucket_sums(load, gen, sell, bucket_id, scales, n_buckets: int,
                impl: str = "auto", packed: Optional[PackedStreams] = None):
    """(signed [N, R, B], imports [N, R, B], export_credit [N, R]) — the
    full reduction set of the battery forward run, over full-hour lanes.

    ``packed``: a full-hour :class:`PackedStreams` whose load/sell/period
    lanes are reused beside a fresh ``gen`` (the battery-modified
    output); a compacted pack is refused."""
    n_periods = _check_buckets(n_buckets)
    _check_impl(impl)
    _check_ids(bucket_id)
    if impl == "dot":
        _reject_packed_for_dot(packed)
        imp, imp_sell, sgn, sgn_sell = dot_sums(load, gen, sell, bucket_id,
                                                scales, n_periods, True)
    else:
        engine = stream_sums if impl == "stream" else month_sums
        lanes = _prep_positional(load, gen, sell, bucket_id, n_periods, None, packed)
        imp, imp_sell, sgn, sgn_sell = engine(*lanes, scales, FULL_OFFSETS,
                                              n_periods, True)
    # exports = relu(-net) = imports - signed, columnwise
    return sgn, imp, imp_sell - sgn_sell


# ---------------------------------------------------------------------------
# Linear bill structure and bills from sums
# ---------------------------------------------------------------------------

def linear_sums(load, gen, sell, hour_period, n_periods: int):
    """Per-agent linear bill structure: (S_load [N, B], S_gen [N, B],
    S_load_sell [N], S_gen_sell [N]). ``signed(s) = S_load - s * S_gen``
    gives the exact NEM monthly sums for any scale; the sell scalars
    close the export-credit identity."""
    n = load.shape[0]
    s_l = monthly_period_sums(load, hour_period, n_periods).reshape(n, -1)
    s_g = monthly_period_sums(gen, hour_period, n_periods).reshape(n, -1)
    return s_l, s_g, (load * sell).sum(dim=1), (gen * sell).sum(dim=1)


def hourly_bucket_ids(hour_period: torch.Tensor, n_periods: int) -> torch.Tensor:
    """[N, 8760] int32 month-major bucket ids from TOU period maps."""
    return (hour_month(hour_period.device)[None, :] * n_periods
            + hour_period).to(torch.int32)


def sell_rate_hourly(tariff: AgentTariff, ts_sell: torch.Tensor) -> torch.Tensor:
    """Hourly sell rate per agent: the tariff's TOU sell price when it
    defines one, else the time-series rate."""
    from dgen_tpu_torch.ops.bill import select_by_period

    tou = select_by_period(tariff.hour_period, tariff.sell_price, ts_sell)
    has_tou = (tariff.sell_price > 0.0).any(dim=1, keepdim=True)
    return torch.where(has_tou, tou, ts_sell)


def _tier_charge_batched(sums_mp: torch.Tensor, tariff: AgentTariff) -> torch.Tensor:
    """[N, R, 12, P] monthly sums -> [N, R] annual tiered charges, as a
    loop over the (small) tier axis so the largest temporary stays
    [N, R, 12, P]."""
    price = tariff.price          # [N, P, T]
    caps = tariff.tier_cap        # [N, T]
    lower = torch.cat([torch.zeros_like(caps[:, :1]), caps[:, :-1]], dim=1)
    width = caps - lower
    total = torch.zeros(sums_mp.shape[:2], dtype=sums_mp.dtype, device=sums_mp.device)
    for t in range(price.shape[-1]):
        lo = lower[:, t][:, None, None, None]
        seg = torch.minimum(torch.clamp_min(sums_mp - lo, 0.0),
                            width[:, t][:, None, None, None])
        total = total + torch.einsum("nrmp,np->nr", seg, price[:, :, t])
    # negative (net-metered export) months credit at the tier-1 price
    return total + torch.einsum(
        "nrmp,np->nr", torch.clamp_max(sums_mp, 0.0), price[:, :, 0])


def bills_from_sums(signed, imports, credit, tariff: AgentTariff,
                    n_periods: int) -> torch.Tensor:
    """Annual bills [N, R] from full bucket sums: tier structure,
    metering selection and fixed charges."""
    n, r, _ = signed.shape
    bill_nem = _tier_charge_batched(signed.reshape(n, r, MONTHS, n_periods), tariff)
    bill_nb = _tier_charge_batched(
        imports.reshape(n, r, MONTHS, n_periods), tariff) - credit
    is_nb = (tariff.metering == NET_BILLING)[:, None]
    energy_bill = torch.where(is_nb, bill_nb, bill_nem)
    return energy_bill + MONTHS * tariff.fixed_monthly[:, None]


def _nem_energy_bill(lin, scales, tariff: AgentTariff, n_periods: int):
    """[N, R] annual NEM energy bills via ``signed(s) = S_load - s * S_gen``."""
    s_load, s_gen = lin[0], lin[1]
    n, r = scales.shape
    signed = s_load[:, None, :] - scales[:, :, None] * s_gen[:, None, :]
    return _tier_charge_batched(signed.reshape(n, r, MONTHS, n_periods), tariff)


def bills_linear_nem(lin, scales, tariff: AgentTariff, n_periods: int):
    """Annual bills [N, R] of an all-net-metering population: the
    linear identity, no hourly work."""
    bill = _nem_energy_bill(lin, scales, tariff, n_periods)
    return bill + MONTHS * tariff.fixed_monthly[:, None]


def bills_linear_nb(lin, imports, imp_sell, scales, tariff: AgentTariff,
                    n_periods: int):
    """Annual bills [N, R] from the search path's reduced outputs: NEM
    by the linear identity, net billing from import sums and the linear
    export-credit identity."""
    s_l_sell, s_g_sell = lin[2], lin[3]
    n, r, _ = imports.shape
    bill_nem = _nem_energy_bill(lin, scales, tariff, n_periods)
    credit = imp_sell - (s_l_sell[:, None] - scales * s_g_sell[:, None])
    bill_nb = _tier_charge_batched(
        imports.reshape(n, r, MONTHS, n_periods), tariff) - credit
    is_nb = (tariff.metering == NET_BILLING)[:, None]
    energy_bill = torch.where(is_nb, bill_nb, bill_nem)
    return energy_bill + MONTHS * tariff.fixed_monthly[:, None]
