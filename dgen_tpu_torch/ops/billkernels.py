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

The month, pair and stream kernels read ``[N, L]`` lanes with 13 month
offsets (:mod:`dgen_tpu_torch.ops.layout`): the plain 8760-hour order,
or a daylight-compacted layout whose night-hour sums (which do not
depend on ``s``) are added after the kernel. :class:`PackedStreams`
holds those lanes built once per sizing call (``RunConfig.pack_once``).
All three stage each agent-month sorted by TOU period and walk the
period runs in lane order (``csrc/staging.cuh``), so on the same
operands the stream kernel's outputs equal the month kernel's bit for
bit, and each half of the pair kernel's equals one month-kernel launch
on that tariff's sell and period lanes.

Stream types. ``load``, ``gen`` and ``sell`` may be float32, bfloat16
(``RunConfig.bf16_banks``) or, for load and gen, int8 codes
(``RunConfig.quant_banks``; :func:`import_sums` and
:func:`import_sums_pair` then take the per-agent ``load_scale`` and
``gen_scale`` and fold them into the scales, :func:`_quant_fold`). The
kernels upcast each element when they read it and sum in float32; the
sums are stored at :func:`_sums_out_dtype` of the stream types. The
(load, gen, sell) combinations the kernels are instantiated for are
:data:`IMPORT_DTYPES` and :data:`SIGNED_DTYPES`; any other raises
``TypeError`` on every device, and nothing is quietly upcast to reach
the float32 kernel.

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

#: scales a thread the month kernel is built for (csrc/bucket_sums.cu;
#: 4 on float32 streams only); by default it takes 1 while R <= 32, else 2
MONTH_SCALES_PER_THREAD_FORMS = (1, 2, 4)

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"month": 0, "month_signed": 0, "month_pair": 0, "stream": 0,
            "stream_signed": 0, "dot": 0, "dot_signed": 0,
            # the micro-benchmark's variants (ops/microkernels.py)
            "monthmask": 0, "monthmask_g": 0, "variant": 0, "monthdot": 0,
            "monthdot_pre": 0, "mnet": 0, "mnet_hi": 0}

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
#: dtype codes of the C launchers (csrc/lanes.cuh)
_DTYPE_CODES = {F32: 0, BF16: 1, I8: 2}
#: (load, gen, sell) dtypes the import kernels (month, pair, stream, dot)
#: are instantiated for: float32 banks, bf16 banks, int8 codes beside a
#: float32 or a bf16 sell stream
IMPORT_DTYPES = ((F32, F32, F32), (BF16, BF16, BF16), (I8, I8, F32),
                 (I8, I8, BF16))
#: ... and the signed kernels (the battery forward run, whose gen is the
#: float32 dispatch output beside the bank's load and sell)
SIGNED_DTYPES = ((F32, F32, F32), (BF16, BF16, BF16), (BF16, F32, BF16),
                 (F32, F32, BF16))

#: launches on narrow streams since the last :func:`reset_launches`, by
#: ``"<LAUNCHES key>/<load dtype>"`` (``"month/bfloat16"``,
#: ``"stream/int8"``); float32 launches count in :data:`LAUNCHES` only
NARROW_LAUNCHES: dict = {}

#: when a dict, each kernel wrapper keeps the arguments of its first
#: launch there under its :data:`LAUNCHES` key, and those of its first
#: launch on narrow streams under its :data:`NARROW_LAUNCHES` key too (to
#: check and time a kernel on the operands a real run gave it)
CAPTURE: dict | None = None

#: bytes of one [N, rc, L] float32 temporary the plain versions allow
_PLAIN_CHUNK_BYTES = 1 << 28


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    NARROW_LAUNCHES.clear()


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


def _sums_out_dtype(load_dtype, gen_dtype, sell_dtype) -> torch.dtype:
    """Stored dtype of the bucket sums: bfloat16 when load and gen are
    bfloat16 (bf16 banks), or when int8 codes ride beside a bfloat16 sell
    stream (int8 composed with bf16 banks); float32 otherwise (a float32
    dispatch output mixed into gen keeps float32 sums). The sums are
    always accumulated in float32; only the stored result takes the
    bank precision."""
    if load_dtype == BF16 and gen_dtype == BF16:
        return BF16
    if load_dtype == I8 and sell_dtype == BF16:
        return BF16
    return F32


def _check_stream_dtypes(load, gen, sell, signed: bool, sell_b=None) -> tuple:
    """The C dtype codes of (load, gen, sell); ``TypeError`` for a
    combination no kernel is instantiated for."""
    combo = (load.dtype, gen.dtype, sell.dtype)
    allowed = SIGNED_DTYPES if signed else IMPORT_DTYPES
    if combo not in allowed:
        names = [tuple(str(d).replace("torch.", "") for d in c) for c in allowed]
        raise TypeError(
            f"(load, gen, sell) dtypes {tuple(str(d) for d in combo)} have no "
            f"{'signed' if signed else 'import'} bucket-sums kernel; the kernels "
            f"take {names}")
    if sell_b is not None and sell_b.dtype != sell.dtype:
        raise TypeError(f"the two sell streams must share a dtype, got "
                        f"{sell.dtype} and {sell_b.dtype}")
    return tuple(_DTYPE_CODES[d] for d in combo)


def _quant_fold(scales, load_scale, gen_scale):
    """int8 banks: fold the per-agent dequantization factors into the
    scales so the kernels run unchanged in quantized units. With load =
    ls * ql and gen = gs * qg (ql, qg the codes, upcast when read),

        relu(ls * ql - s * gs * qg) = ls * relu(ql - (s * gs / ls) * qg),

    so every bucket column and the sell-weighted column scale by ``ls``
    (the sell rate is never quantized). Returns (effective scales,
    per-agent post factor) for :func:`_quant_unfold`; (scales, None)
    without scales. ``ls == 0`` (an identically-zero load row) is floored
    here and zeroed by the post multiply."""
    if (load_scale is None) != (gen_scale is None):
        raise ValueError("load_scale and gen_scale go together")
    if load_scale is None:
        return scales, None
    safe = torch.clamp_min(load_scale, 1e-20)
    return scales * (gen_scale / safe)[:, None], load_scale


def _quant_unfold(outs, post) -> tuple:
    """The engine's outputs times the post factor, in float32, stored
    back at their dtype."""
    if post is None:
        return tuple(outs)
    return tuple((o.float() * post.view(-1, *[1] * (o.ndim - 1))).to(o.dtype)
                 for o in outs)


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
                  device, dtype=F32) -> list:
    """[imports [N, R, 12P], imp_sell [N, R], signed, sgn_sell] buffers of
    ``dtype``; the signed pair is None unless ``with_signed``."""
    kw = dict(dtype=dtype, device=device)

    def sums_and_sell():
        return [torch.empty((n, r, MONTHS * n_periods), **kw),
                torch.empty((n, r), **kw)]

    return sums_and_sell() + (sums_and_sell() if with_signed else [None, None])


def _scale_chunk(n: int, lanes: int) -> int:
    return max(1, _PLAIN_CHUNK_BYTES // max(1, n * lanes * 4))


def _upcast(*streams) -> tuple:
    """(out dtype of the first three streams, the streams as float32)."""
    out = _sums_out_dtype(*(t.dtype for t in streams[:3]))
    return out, tuple(t.float() for t in streams)


def _store(outs, dtype) -> tuple:
    return tuple(None if o is None else o.to(dtype) for o in outs)


def month_sums_plain(load, gen, sell, period, scales, offsets, n_periods: int,
                     with_signed: bool):
    """Plain version of the month and stream kernels over ``[N, L]``
    lanes with month ``m`` in ``[offsets[m], offsets[m + 1])``:
    (imports [N, R, 12P], imp_sell [N, R]) and, when ``with_signed``,
    also (signed, sgn_sell). Loops over chunks of scales with per-period
    masks against the lane-month one-hot. Narrow streams are upcast and
    the float32 sums stored at :func:`_sums_out_dtype`, as the kernels
    do."""
    out_dtype, (load, gen, sell) = _upcast(load, gen, sell)
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
        return _store((imp, imp_sell, sgn, sgn_sell), out_dtype)
    return _store((imp, imp_sell), out_dtype)


def month_pair_sums_plain(load, gen, sell_a, period_a, sell_b, period_b,
                          scales, offsets, n_periods: int):
    """Plain version of the pair kernel: (imports_a, imp_sell_a,
    imports_b, imp_sell_b) over one shared relu(net) on ``[N, L]``
    lanes."""
    out_dtype, (load, gen, sell_a, sell_b) = _upcast(load, gen, sell_a, sell_b)
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
    return _store(out, out_dtype)


def dot_sums_plain(load, gen, sell, bucket_id, scales, n_periods: int,
                   with_signed: bool):
    """Plain version of the dot kernel: per chunk of hours, the one-hot
    bucket matrix M [N, Hc, 12P + 1] (sell rate in the last column) and
    ``relu(net) @ M`` (and ``net @ M``). Outputs as
    :func:`month_sums_plain`."""
    out_dtype, (load, gen, sell) = _upcast(load, gen, sell)
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
    return _store(out, out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_inputs(streams, ints, scales, lanes: int,
                         narrow: bool = False) -> tuple[int, int]:
    """(N, R) after checking device, dtype, shape and contiguity; the
    streams are float32, or with ``narrow`` of the dtypes the caller
    checked with :func:`_check_stream_dtypes`."""
    n, r = scales.shape
    dev = scales.device
    for name, t, dtype, shape in (
        [("stream", t, t.dtype if narrow else F32, (n, lanes)) for t in streams]
        + [("period or bucket ids", t, torch.int32, (n, lanes)) for t in ints]
        + [("scales", scales, F32, (n, r))]
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


def _count(key: str, args: tuple, load_dtype=F32) -> None:
    LAUNCHES[key] += 1
    narrow = None
    if load_dtype != F32:
        narrow = f"{key}/{str(load_dtype).replace('torch.', '')}"
        NARROW_LAUNCHES[narrow] = NARROW_LAUNCHES.get(narrow, 0) + 1
    if CAPTURE is not None:
        CAPTURE.setdefault(key, args)
        if narrow is not None:
            CAPTURE.setdefault(narrow, args)


def _lane_sums(fn_name: str, key: str, load, gen, sell, period, scales,
               offsets, n_periods: int, with_signed: bool, codes: tuple,
               extra: tuple = ()):
    n, r = _check_kernel_inputs((load, gen, sell), (period,), scales,
                                load.shape[1], narrow=True)
    out = _sums_buffers(n, r, n_periods, with_signed, scales.device,
                        _sums_out_dtype(load.dtype, gen.dtype, sell.dtype))
    if n and r:
        _launch(fn_name, scales, _ptr(load), _ptr(gen), _ptr(sell), _ptr(period),
                _ptr(scales), _offsets_arg(offsets, load.shape[1]),
                *(_ptr(o) for o in out), n, r, load.shape[1], n_periods,
                int(with_signed), *codes, *extra)
        _count(key + ("_signed" if with_signed else ""),
               (load, gen, sell, period, scales, offsets, n_periods, with_signed),
               load.dtype)
    return tuple(out if with_signed else out[:2])


def month_sums(load, gen, sell, period, scales, offsets, n_periods: int,
               with_signed: bool, scales_per_thread: Optional[int] = None):
    """Month bucket sums over lanes (see :func:`month_sums_plain` for the
    outputs): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU one. ``scales_per_thread`` times the kernel's other forms (one
    of :data:`MONTH_SCALES_PER_THREAD_FORMS`; None = the kernel's own
    choice); every form sums in the same order, and the plain version
    has none."""
    codes = _check_stream_dtypes(load, gen, sell, with_signed)
    if scales_per_thread not in (None, *MONTH_SCALES_PER_THREAD_FORMS):
        raise ValueError(f"scales_per_thread {scales_per_thread} is not one of "
                         f"{MONTH_SCALES_PER_THREAD_FORMS}")
    if scales_per_thread == 4 and any(c != _DTYPE_CODES[F32] for c in codes):
        raise TypeError("scales_per_thread 4 needs float32 streams")
    if scales.device.type == "cpu":
        return month_sums_plain(load, gen, sell, period, scales, offsets,
                                n_periods, with_signed)
    if scales_per_thread is None:
        return _lane_sums("bucket_sums_month", "month", load, gen, sell, period,
                          scales, offsets, n_periods, with_signed, codes)
    return _lane_sums("bucket_sums_month_spt", "month", load, gen, sell, period,
                      scales, offsets, n_periods, with_signed, codes,
                      (scales_per_thread,))


def stream_sums(load, gen, sell, period, scales, offsets, n_periods: int,
                with_signed: bool):
    """The month kernel's function on the segment-streaming kernel: the
    CUDA kernel on a CUDA tensor, :func:`month_sums_plain` on a CPU
    one. On the card its outputs equal :func:`month_sums`' bit for bit
    (the same period runs, summed in the same order; on compacted lanes,
    lanes whose load and gen are both zero, which add nothing, are not
    staged)."""
    codes = _check_stream_dtypes(load, gen, sell, with_signed)
    if scales.device.type == "cpu":
        return month_sums_plain(load, gen, sell, period, scales, offsets,
                                n_periods, with_signed)
    return _lane_sums("bucket_sums_stream", "stream", load, gen, sell, period,
                      scales, offsets, n_periods, with_signed, codes)


def month_pair_sums(load, gen, sell_a, period_a, sell_b, period_b, scales,
                    offsets, n_periods: int):
    """Pair bucket sums over lanes (see :func:`month_pair_sums_plain`):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU one. On
    the card (imports_a, imp_sell_a) equal :func:`month_sums` on
    ``(load, gen, sell_a, period_a)`` bit for bit, and the B outputs
    likewise: one staging of load and gen feeds two period partitions
    (on compacted lanes, lanes whose load and gen are both zero are not
    staged)."""
    codes = _check_stream_dtypes(load, gen, sell_a, False, sell_b=sell_b)
    if scales.device.type == "cpu":
        return month_pair_sums_plain(load, gen, sell_a, period_a, sell_b,
                                     period_b, scales, offsets, n_periods)
    n, r = _check_kernel_inputs((load, gen, sell_a, sell_b), (period_a, period_b),
                                scales, load.shape[1], narrow=True)
    out = tuple(_sums_buffers(n, r, n_periods, True, scales.device,
                              _sums_out_dtype(load.dtype, gen.dtype, sell_a.dtype)))
    if n and r:
        _launch("bucket_sums_month_pair", scales, _ptr(load), _ptr(gen),
                _ptr(sell_a), _ptr(period_a), _ptr(sell_b), _ptr(period_b),
                _ptr(scales), _offsets_arg(offsets, load.shape[1]),
                *(_ptr(o) for o in out), n, r, load.shape[1], n_periods, *codes)
        _count("month_pair", (load, gen, sell_a, period_a, sell_b, period_b,
                              scales, offsets, n_periods), load.dtype)
    return out


def dot_sums(load, gen, sell, bucket_id, scales, n_periods: int,
             with_signed: bool):
    """Bucket sums on the one-hot tensor-core kernel over full-hour
    streams and bucket ids (see :func:`dot_sums_plain`): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU one. The kernel's import
    products take TF32 operands and its signed products 3xTF32 ones (the
    signed terms cancel), both summed in float32. It takes float32 and
    bfloat16 streams and the bucket ids at 16-byte aligned addresses and
    int8 streams at 8-byte aligned ones (any row of an array from the
    allocator); a stream that starts elsewhere raises."""
    codes = _check_stream_dtypes(load, gen, sell, with_signed)
    if scales.device.type == "cpu":
        return dot_sums_plain(load, gen, sell, bucket_id, scales, n_periods,
                              with_signed)
    n, r = _check_kernel_inputs((load, gen, sell), (bucket_id,), scales, HOURS,
                                narrow=True)
    out = _sums_buffers(n, r, n_periods, with_signed, scales.device,
                        _sums_out_dtype(load.dtype, gen.dtype, sell.dtype))
    if n and r:
        _launch("bucket_sums_dot", scales, _ptr(load), _ptr(gen), _ptr(sell),
                _ptr(bucket_id), _ptr(scales), *(_ptr(o) for o in out), n, r,
                HOURS, n_periods, int(with_signed), *codes)
        _count("dot_signed" if with_signed else "dot",
               (load, gen, sell, bucket_id, scales, n_periods, with_signed),
               load.dtype)
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
    # float and int8 lanes keep their dtype (0/1 is exact in every one)
    return [a.index_select(1, idx) if a.dtype == torch.int32
            else a.index_select(1, idx) * valid.to(a.dtype) for a in arrays]


def night_sums(load, sell, bucket_id, night, n_periods: int, with_signed: bool):
    """Scale-independent bucket sums of the night hours (``night`` [8760]
    is 1 where no profile generates): there ``relu(load - s * gen) ==
    relu(load)`` and the signed net is ``load`` for every scale. Returns
    (imports, signed-or-None), each a pair (buckets [N, 12P], sell sum
    [N]), float32 whatever the stream dtypes (int8 load codes give sums
    in quantized units, unfolded with the kernel's)."""
    n = load.shape[0]
    hour_period = _periods(bucket_id, n_periods)
    sell = sell.float()

    def sums(x):
        return (monthly_period_sums(x, hour_period, n_periods).reshape(n, -1),
                (x * sell).sum(dim=1))

    load_n = load.float() * night[None, :]
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
    """The kernel's sums plus the night sums, added in float32 and stored
    back at the sums' dtype."""
    if night is None:
        return sums, sell_sum
    return ((sums.float() + night[0][:, None, :]).to(sums.dtype),
            (sell_sum.float() + night[1][:, None]).to(sell_sum.dtype))


def _reject_packed_for_dot(packed) -> None:
    if packed is not None:
        raise ValueError("the dot engine is full-hour and does not consume "
                         "packed streams")


# ---------------------------------------------------------------------------
# Engine entries
# ---------------------------------------------------------------------------

def import_sums(load, gen, sell, bucket_id, scales, n_buckets: int,
                impl: str = "auto", layout: Optional[DaylightLayout] = None,
                packed: Optional[PackedStreams] = None, load_scale=None,
                gen_scale=None):
    """(imports [N, R, B], imp_sell [N, R]): positive-part bucket sums
    and the sell-weighted positive-part sum for R net-load scales.

    ``layout``: a :class:`DaylightLayout` under which the kernel runs the
    compacted lanes only and the night sums are added back (valid where
    ``gen`` is zero off-daylight); totals cover all hours either way.
    ``packed``: lanes from :func:`pack_streams` for the same layout (the
    raw streams may then be None). ``load_scale``/``gen_scale``: [N]
    float32 dequantization factors of int8 load/gen codes
    (:func:`_quant_fold`); the kernels run in quantized units and the
    outputs rescale once."""
    n_periods = _check_buckets(n_buckets)
    _check_impl(impl)
    _check_ids(bucket_id)
    scales, post = _quant_fold(scales, load_scale, gen_scale)
    if impl == "dot":
        _reject_packed_for_dot(packed)
        out = dot_sums(load, gen, sell, bucket_id, scales, n_periods, False)
        return _quant_unfold(out, post)
    engine = stream_sums if impl == "stream" else month_sums
    lanes = _prep_positional(load, gen, sell, bucket_id, n_periods, layout, packed)
    imp, imp_sell = engine(*lanes, scales, _offsets(layout), n_periods, False)
    night_i, _ = _night_for(load, sell, bucket_id, layout, n_periods, False, packed)
    return _quant_unfold(_add_night(imp, imp_sell, night_i), post)


def import_sums_pair(load, gen, sell_a, bucket_a, sell_b, bucket_b, scales,
                     n_buckets: int, impl: str = "auto",
                     layout: Optional[DaylightLayout] = None,
                     packed: Optional[PackedStreams] = None, load_scale=None,
                     gen_scale=None):
    """(imports_a, imp_sell_a, imports_b, imp_sell_b): the rate-switch
    search's two tariff structures (switched, original) priced over ONE
    shared ``relu(load - s * gen)``, on the pair kernel under ``"auto"``
    and ``"stream"``; ``layout``/``packed``/``load_scale``/``gen_scale``
    as in :func:`import_sums` (a pack built with ``sell_b``/``bucket_b``
    carries both)."""
    n_periods = _check_buckets(n_buckets)
    _check_impl(impl)
    _check_ids(bucket_a, bucket_b)
    scales, post = _quant_fold(scales, load_scale, gen_scale)
    if impl == "dot":
        _reject_packed_for_dot(packed)
        return _quant_unfold(
            dot_sums(load, gen, sell_a, bucket_a, scales, n_periods, False)
            + dot_sums(load, gen, sell_b, bucket_b, scales, n_periods, False), post)
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
    return _quant_unfold(_add_night(out[0], out[1], night_a)
                         + _add_night(out[2], out[3], night_b), post)


def bucket_sums(load, gen, sell, bucket_id, scales, n_buckets: int,
                impl: str = "auto", packed: Optional[PackedStreams] = None):
    """(signed [N, R, B], imports [N, R, B], export_credit [N, R]) — the
    full reduction set of the battery forward run, over full-hour lanes
    (stream dtypes: :data:`SIGNED_DTYPES`; the credit is their difference
    at the sums' dtype).

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
    close the export-credit identity. The streams are upcast to float32
    first: an 8760-term sum at bank precision would lose the identity's
    precision."""
    load, gen, sell = load.float(), gen.float(), sell.float()
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
    # the bank's dtype: under bf16 banks the sell stream is bf16 too
    return torch.where(has_tou, tou, ts_sell).to(ts_sell.dtype)


def _tier_charge_batched(sums_mp: torch.Tensor, tariff: AgentTariff) -> torch.Tensor:
    """[N, R, 12, P] monthly sums -> [N, R] annual tiered charges, as a
    loop over the (small) tier axis so the largest temporary stays
    [N, R, 12, P]. Sums stored at bank precision are upcast first."""
    sums_mp = sums_mp.float()
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
