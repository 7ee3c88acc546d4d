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

The reductions run in the hand-written CUDA kernels of
``csrc/bucket_sums.cu`` on a CUDA tensor and in their plain PyTorch
versions (the twin of the JAX package's ``_sums_xla``) on a CPU tensor.
Each kernel wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from dgen_tpu_torch.ops.bill import AgentTariff, hour_month, month_onehot, monthly_period_sums
from dgen_tpu_torch.ops.tariff import HOURS, MONTHS, NET_BILLING

#: most TOU periods a tariff bank may carry (12 * 10 buckets)
MAX_PERIODS = 10

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES = {"month": 0, "month_signed": 0, "month_pair": 0}

#: when a dict, each kernel wrapper keeps the arguments of its first
#: launch there under its :data:`LAUNCHES` key (to check and time a
#: kernel on the operands a real run gave it)
CAPTURE: dict | None = None

#: bytes of one [N, rc, 8760] float32 temporary the plain versions allow
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


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _bucketize(x: torch.Tensor, masks: list, onehot: torch.Tensor) -> torch.Tensor:
    """[N, rc, H] -> [N, rc, 12 * P] month-major bucket sums."""
    cols = [(x * m[:, None, :]) @ onehot for m in masks]
    return torch.stack(cols, dim=-1).reshape(x.shape[0], x.shape[1], -1)


def _scale_chunk(n: int) -> int:
    return max(1, _PLAIN_CHUNK_BYTES // max(1, n * HOURS * 4))


def month_sums_plain(load, gen, sell, bucket_id, scales, n_periods: int,
                     with_signed: bool):
    """Plain version of the month kernel: (imports [N, R, 12P],
    imp_sell [N, R]) and, when ``with_signed``, also (signed, sgn_sell).
    Loops over chunks of scales and buckets with per-period masks
    against the month one-hot."""
    n, r = scales.shape
    nb = MONTHS * n_periods
    period = bucket_id % n_periods
    masks = [(period == p).to(torch.float32) for p in range(n_periods)]
    onehot = month_onehot(load.device)
    f32 = dict(dtype=torch.float32, device=load.device)
    imp = torch.empty((n, r, nb), **f32)
    imp_sell = torch.empty((n, r), **f32)
    sgn = torch.empty((n, r, nb), **f32) if with_signed else None
    sgn_sell = torch.empty((n, r), **f32) if with_signed else None
    rc = _scale_chunk(n)
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


def month_pair_sums_plain(load, gen, sell_a, bucket_a, sell_b, bucket_b,
                          scales, n_periods: int):
    """Plain version of the pair kernel: (imports_a, imp_sell_a,
    imports_b, imp_sell_b) over one shared relu(net)."""
    n, r = scales.shape
    nb = MONTHS * n_periods
    onehot = month_onehot(load.device)
    masks_a = [((bucket_a % n_periods) == p).to(torch.float32) for p in range(n_periods)]
    masks_b = [((bucket_b % n_periods) == p).to(torch.float32) for p in range(n_periods)]
    f32 = dict(dtype=torch.float32, device=load.device)
    out = [torch.empty((n, r, nb), **f32), torch.empty((n, r), **f32),
           torch.empty((n, r, nb), **f32), torch.empty((n, r), **f32)]
    rc = _scale_chunk(n)
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        pos = torch.clamp_min(load[:, None, :] - s[:, :, None] * gen[:, None, :], 0.0)
        out[0][:, r0:r0 + rc] = _bucketize(pos, masks_a, onehot)
        out[1][:, r0:r0 + rc] = (pos * sell_a[:, None, :]).sum(dim=2)
        out[2][:, r0:r0 + rc] = _bucketize(pos, masks_b, onehot)
        out[3][:, r0:r0 + rc] = (pos * sell_b[:, None, :]).sum(dim=2)
    return tuple(out)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_inputs(streams, buckets, scales) -> tuple[int, int]:
    n, r = scales.shape
    dev = scales.device
    for name, t, dtype, shape in (
        [("stream", t, torch.float32, (n, HOURS)) for t in streams]
        + [("bucket ids", t, torch.int32, (n, HOURS)) for t in buckets]
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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _count(key: str, args: tuple) -> None:
    LAUNCHES[key] += 1
    if CAPTURE is not None:
        CAPTURE.setdefault(key, args)


def month_sums(load, gen, sell, bucket_id, scales, n_periods: int,
               with_signed: bool):
    """Month bucket sums (see :func:`month_sums_plain` for the outputs):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU one."""
    if scales.device.type == "cpu":
        return month_sums_plain(load, gen, sell, bucket_id, scales, n_periods,
                                with_signed)
    from dgen_tpu_torch.ops import _build

    n, r = _check_kernel_inputs((load, gen, sell), (bucket_id,), scales)
    nb = MONTHS * n_periods
    f32 = dict(dtype=torch.float32, device=scales.device)
    imp = torch.empty((n, r, nb), **f32)
    imp_sell = torch.empty((n, r), **f32)
    sgn = torch.empty((n, r, nb), **f32) if with_signed else None
    sgn_sell = torch.empty((n, r), **f32) if with_signed else None
    if n and r:
        with torch.cuda.device(scales.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _build.library().bucket_sums_month(
                _ptr(load), _ptr(gen), _ptr(sell), _ptr(bucket_id), _ptr(scales),
                _ptr(imp), _ptr(imp_sell), _ptr(sgn), _ptr(sgn_sell),
                n, r, n_periods, int(with_signed), ctypes.c_void_p(stream),
            )
        _raise_on(rc, "bucket_sums_month")
        _count("month_signed" if with_signed else "month",
               (load, gen, sell, bucket_id, scales, n_periods, with_signed))
    if with_signed:
        return imp, imp_sell, sgn, sgn_sell
    return imp, imp_sell


def month_pair_sums(load, gen, sell_a, bucket_a, sell_b, bucket_b, scales,
                    n_periods: int):
    """Pair bucket sums (see :func:`month_pair_sums_plain`): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if scales.device.type == "cpu":
        return month_pair_sums_plain(load, gen, sell_a, bucket_a, sell_b,
                                     bucket_b, scales, n_periods)
    from dgen_tpu_torch.ops import _build

    n, r = _check_kernel_inputs((load, gen, sell_a, sell_b),
                                (bucket_a, bucket_b), scales)
    nb = MONTHS * n_periods
    f32 = dict(dtype=torch.float32, device=scales.device)
    out = (torch.empty((n, r, nb), **f32), torch.empty((n, r), **f32),
           torch.empty((n, r, nb), **f32), torch.empty((n, r), **f32))
    if n and r:
        with torch.cuda.device(scales.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _build.library().bucket_sums_month_pair(
                _ptr(load), _ptr(gen), _ptr(sell_a), _ptr(bucket_a),
                _ptr(sell_b), _ptr(bucket_b), _ptr(scales),
                *(_ptr(o) for o in out), n, r, n_periods,
                ctypes.c_void_p(stream),
            )
        _raise_on(rc, "bucket_sums_month_pair")
        _count("month_pair", (load, gen, sell_a, bucket_a, sell_b, bucket_b,
                              scales, n_periods))
    return out


# ---------------------------------------------------------------------------
# Engine entries
# ---------------------------------------------------------------------------

def import_sums(load, gen, sell, bucket_id, scales, n_buckets: int):
    """(imports [N, R, B], imp_sell [N, R]): positive-part bucket sums
    and the sell-weighted positive-part sum for R net-load scales."""
    n_periods = _check_buckets(n_buckets)
    return month_sums(load, gen, sell, bucket_id, scales, n_periods, False)


def import_sums_pair(load, gen, sell_a, bucket_a, sell_b, bucket_b, scales,
                     n_buckets: int):
    """(imports_a, imp_sell_a, imports_b, imp_sell_b): the rate-switch
    search's two tariff structures (switched, original) priced over ONE
    shared ``relu(load - s * gen)``."""
    n_periods = _check_buckets(n_buckets)
    return month_pair_sums(load, gen, sell_a, bucket_a, sell_b, bucket_b,
                           scales, n_periods)


def bucket_sums(load, gen, sell, bucket_id, scales, n_buckets: int):
    """(signed [N, R, B], imports [N, R, B], export_credit [N, R]) — the
    full reduction set of the battery forward run."""
    n_periods = _check_buckets(n_buckets)
    imp, imp_sell, sgn, sgn_sell = month_sums(
        load, gen, sell, bucket_id, scales, n_periods, True)
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
