"""Bucket-sums kernel variants of the micro-benchmark: the counterpart
of the Pallas variants in ``tools/kernel_microbench.py``.

Six alternative designs of the import bucket sums of
:mod:`dgen_tpu_torch.ops.billkernels`, each there to isolate one
question about where a bucket-sums kernel's time goes:

  * :func:`sums_monthmask` (``csrc/microbench_mask.cu``): per month a
    month total and P - 1 masked period sums in a run-time loop over the
    periods, the last period as ``total - others``; no one-hot, no
    product. The subtraction is part of the function: its float32
    cancellation is what the JAX kernel returns too.
  * :func:`sums_monthmask_g`: the same arithmetic with ``g_block``
    agents per block of threads.
  * :func:`sums_variant` (``csrc/microbench_dot.cu``): the one-hot
    tensor-core kernel over hour chunks (``wgmma`` m64nNk8 TF32, N the
    ``b_pad`` columns, relu(net) in registers and M in shared memory)
    with its stages switched:
    ``build`` = ``"onehot"`` (M formed from the bucket ids) / ``"const"``
    (M = 0.01 everywhere, nothing formed) / ``"hbm"`` (M read from device
    memory, ``m_hbm`` [N, 8760, b_pad]); ``dot`` = ``"dot"`` / ``"none"``
    (no product: ``sum(pos) + sum(M[:, 0])`` per chunk lands in every
    column); ``net`` = ``"fma"`` / ``"bcast"`` (``load`` alone, no scale
    multiply). The ablated forms compute nonsense on purpose: they exist
    to be timed, and their plain versions define them as exactly.
  * :func:`sums_monthdot`: per month one product of relu(net) with a
    matrix built from the period lane by position (the month's P period
    columns and the sell rate), accumulated over the 12 months
    (``mma.sync`` m16n8k8 TF32, both operands formed in registers).
  * :func:`sums_monthdot_pre` (``csrc/microbench_pre.cu``): per month one
    narrow tensor-core product of relu(net) with PREBUILT mask columns
    M [N, c_pad, 8760] (:func:`build_mask_cols`: P - 1 period one-hots,
    ones, the sell rate), so the kernel forms only relu(net); the last
    period is the month total minus the others.
  * :func:`sums_mnet`: the same with net itself a rank-1 tensor-core
    product ``(1, -s) x (load; gen)``; ``hi=True`` runs both products in
    3xTF32 (float32-level), ``hi=False`` in plain TF32.

Decisions that hold for all six:

  * *Outputs.* ``(imports [N, R, 12P], imp_sell [N, R])``, float32, as
    the engines of :mod:`billkernels` return. (The JAX functions return
    one ``[N, r_pad, b_pad]`` array, bucket columns first and the sell
    sum in column ``b_pad - 1``; that is the other package's tiling.)
  * *Lanes.* The plain 8760-hour order with the 13 month offsets of
    :data:`dgen_tpu_torch.ops.layout.FULL_OFFSETS`; no month-padded
    repack.
  * *b_pad* is the number of columns of M that :func:`sums_variant`
    forms and multiplies: a multiple of 16, at least ``12 P + 1`` and at
    most 128. The sell rate rides in column ``b_pad - 1``. A ``b_pad``
    that cannot hold ``12 P + 1`` columns is refused (buckets would
    alias). The other three form only the columns they need, so they
    take no ``b_pad``.
  * *g_block.* N must be a multiple of ``g_block``; a ragged tail is
    refused, not dropped.
  * *h_chunk* (hours staged per step of :func:`sums_variant`): a
    multiple of 8 that divides 8760; None = 40.
  * *c_pad* (rows of the prebuilt M): 8 or 16 (one or two 8-column
    tensor-core tiles), at least ``P + 1``; a smaller one is refused, as
    the JAX function's pad refuses it. The timed kernels take M as an
    operand (``prebuilt=``); built inside the call when it is None.

On a CUDA tensor each function launches its kernel or raises; on a CPU
tensor it runs its plain PyTorch version (``*_plain``, same arguments).
Launches are counted in :data:`billkernels.LAUNCHES` under
``"monthmask"``, ``"monthmask_g"``, ``"variant"``, ``"monthdot"``,
``"monthdot_pre"``, ``"mnet"`` and ``"mnet_hi"``. The variants read
float32 streams only, as the JAX tool's kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch

from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops.layout import FULL_OFFSETS
from dgen_tpu_torch.ops.tariff import HOURS, MONTHS

BUILDS = ("onehot", "const", "hbm")
DOTS = ("dot", "none")
NETS = ("fma", "bcast")

#: most columns of M the variant kernel forms (eight 16-column tiles)
MAX_B_PAD = 128
#: hours per staged chunk of the variant kernel when ``h_chunk`` is None
DEFAULT_H_CHUNK = 40
#: the value of every element of M under ``build="const"``
CONST_M = 0.01
#: rows of the prebuilt mask matrix the tensor-core kernels take
C_PADS = (8, 16)

_LONGEST_MONTH = max(b - a for a, b in zip(FULL_OFFSETS, FULL_OFFSETS[1:]))


def _check_periods(n_periods: int) -> int:
    if not 1 <= n_periods <= bk.MAX_PERIODS:
        raise ValueError(f"n_periods must lie in 1..{bk.MAX_PERIODS}, got "
                         f"{n_periods}")
    return MONTHS * n_periods


def _check_g_block(n: int, g_block: int) -> None:
    if g_block < 1 or n % g_block:
        raise ValueError(f"{n} agents are not a multiple of g_block={g_block}")


def _check_c_pad(n_periods: int, c_pad: int) -> None:
    _check_periods(n_periods)
    if c_pad not in C_PADS or c_pad < n_periods + 1:
        raise ValueError(
            f"c_pad={c_pad} must be one of {C_PADS} and hold the {n_periods - 1} "
            f"period one-hots, the ones and the sell rate ({n_periods + 1} rows)")


def _check_mask(m, load, c_pad: int) -> None:
    want = (load.shape[0], c_pad, HOURS)
    if m.dtype != torch.float32 or m.device != load.device:
        raise TypeError(f"M must be float32 on {load.device}, got {m.dtype} on "
                        f"{m.device}")
    if tuple(m.shape) != want or not m.is_contiguous():
        raise ValueError(f"M must be contiguous {list(want)}, got "
                         f"{list(m.shape)}")


def _check_variant(n_periods, b_pad, build, dot, net, m_hbm, h_chunk, n,
                   device) -> int:
    """The hours per chunk, after refusing what no form takes."""
    nb = _check_periods(n_periods)
    if b_pad % 16 or not nb + 1 <= b_pad <= MAX_B_PAD:
        raise ValueError(
            f"b_pad={b_pad} must be a multiple of 16 in [{nb + 1}, {MAX_B_PAD}]: "
            f"M needs {nb} bucket columns and the sell column")
    for name, value, choices in (("build", build, BUILDS), ("dot", dot, DOTS),
                                 ("net", net, NETS)):
        if value not in choices:
            raise ValueError(f"{name} must be one of {choices}, got {value!r}")
    if (m_hbm is not None) != (build == "hbm"):
        raise ValueError("m_hbm goes with build='hbm', and only with it")
    if m_hbm is not None:
        if m_hbm.dtype != torch.float32 or m_hbm.device != device:
            raise TypeError(f"m_hbm must be float32 on {device}, got "
                            f"{m_hbm.dtype} on {m_hbm.device}")
        if tuple(m_hbm.shape) != (n, HOURS, b_pad) or not m_hbm.is_contiguous():
            raise ValueError(f"m_hbm must be contiguous [{n}, {HOURS}, {b_pad}], "
                             f"got {tuple(m_hbm.shape)}")
    hc = DEFAULT_H_CHUNK if h_chunk is None else h_chunk
    if hc < 8 or hc % 8 or HOURS % hc:
        raise ValueError(f"h_chunk={hc} must be a multiple of 8 that divides "
                         f"{HOURS}")
    return hc


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' reference on the card)
# ---------------------------------------------------------------------------

def _month_slices():
    return list(zip(FULL_OFFSETS, FULL_OFFSETS[1:]))


def _pos(load, gen, scales, a: int, b: int) -> torch.Tensor:
    """relu(load - s * gen) [N, rc, b - a] over hours [a, b)."""
    return torch.clamp_min(
        load[:, None, a:b] - scales[:, :, None] * gen[:, None, a:b], 0.0)


def sums_monthmask_plain(load, gen, sell, bucket_id, scales, *, n_periods=2):
    """Plain version of :func:`sums_monthmask` and
    :func:`sums_monthmask_g`: per month the total, P - 1 masked period
    sums, and the last period as the total minus the others in turn."""
    nb = _check_periods(n_periods)
    n, r = scales.shape
    period = bucket_id % n_periods
    masks = [(period == p).to(torch.float32) for p in range(n_periods - 1)]
    imp, imp_sell = bk._sums_buffers(n, r, n_periods, False, scales.device)[:2]
    imp = imp.view(n, r, MONTHS, n_periods)
    imp_sell.zero_()
    rc = bk._scale_chunk(n, _LONGEST_MONTH)
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        for m, (a, b) in enumerate(_month_slices()):
            pos = _pos(load, gen, s, a, b)
            imp_sell[:, r0:r0 + rc] += (pos * sell[:, None, a:b]).sum(dim=2)
            rem = pos.sum(dim=2)
            for p, mask in enumerate(masks):
                s_pm = (pos * mask[:, None, a:b]).sum(dim=2)
                imp[:, r0:r0 + rc, m, p] = s_pm
                rem = rem - s_pm
            imp[:, r0:r0 + rc, m, n_periods - 1] = rem
    return imp.view(n, r, nb), imp_sell


def sums_monthmask_g_plain(load, gen, sell, bucket_id, scales, *, n_periods=2,
                           g_block=8):
    """Plain version of :func:`sums_monthmask_g`: the grouping changes no
    arithmetic, so this is :func:`sums_monthmask_plain` after the
    ``g_block`` check."""
    _check_g_block(scales.shape[0], g_block)
    return sums_monthmask_plain(load, gen, sell, bucket_id, scales,
                                n_periods=n_periods)


def sums_monthdot_plain(load, gen, sell, bucket_id, scales, *, n_periods=2):
    """Plain version of :func:`sums_monthdot`: per month relu(net)
    [N, rc, hours] times M [N, hours, P + 1], the one-hot of the period
    lane and the sell rate in the last column."""
    nb = _check_periods(n_periods)
    n, r = scales.shape
    period = (bucket_id % n_periods).long()
    imp, imp_sell = bk._sums_buffers(n, r, n_periods, False, scales.device)[:2]
    imp = imp.view(n, r, MONTHS, n_periods)
    imp_sell.zero_()
    mats = []
    for a, b in _month_slices():
        m = torch.zeros((n, b - a, n_periods + 1), dtype=torch.float32,
                        device=scales.device)
        m.scatter_(2, period[:, a:b, None], 1.0)
        m[:, :, n_periods] = sell[:, a:b]
        mats.append(m)
    rc = bk._scale_chunk(n, _LONGEST_MONTH)
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        for m, (a, b) in enumerate(_month_slices()):
            out = torch.bmm(_pos(load, gen, s, a, b), mats[m])
            imp[:, r0:r0 + rc, m] = out[..., :n_periods]
            imp_sell[:, r0:r0 + rc] += out[..., n_periods]
    return imp.view(n, r, nb), imp_sell


def build_mask_cols(sell, period, n_periods: int, c_pad: int = 8) -> torch.Tensor:
    """[N, c_pad, 8760] float32 mask columns of the prebuilt-mask kernels:
    rows ``0..P-2`` the period one-hots of ``period`` [N, 8760] (the
    hour's TOU period), row ``P-1`` ones (the month total), row ``P`` the
    sell rate, the rest zero. Plain PyTorch (an XLA pass in the JAX
    tool), over the plain 8760-hour lanes."""
    _check_c_pad(n_periods, c_pad)
    n = sell.shape[0]
    m = torch.zeros((n, c_pad, HOURS), dtype=torch.float32, device=sell.device)
    for p in range(n_periods - 1):
        m[:, p] = period == p
    m[:, n_periods - 1] = 1.0
    m[:, n_periods] = sell
    return m


def mask_product_plain(load, gen, m, scales, *, n_periods=2):
    """Plain version of the prebuilt-mask kernels: per month relu(net)
    [N, rc, hours] times M^T [N, hours, c_pad]; the P - 1 period columns,
    the last period as the month total minus them in turn, and the sell
    column summed over the months."""
    nb = _check_periods(n_periods)
    n, r = scales.shape
    imp, imp_sell = bk._sums_buffers(n, r, n_periods, False, scales.device)[:2]
    imp = imp.view(n, r, MONTHS, n_periods)
    imp_sell.zero_()
    rc = bk._scale_chunk(n, _LONGEST_MONTH)
    for r0 in range(0, r, rc):
        s = scales[:, r0:r0 + rc]
        for mo, (a, b) in enumerate(_month_slices()):
            sums = torch.bmm(_pos(load, gen, s, a, b), m[:, :, a:b].transpose(1, 2))
            rem = sums[..., n_periods - 1]
            for p in range(n_periods - 1):
                imp[:, r0:r0 + rc, mo, p] = sums[..., p]
                rem = rem - sums[..., p]
            imp[:, r0:r0 + rc, mo, n_periods - 1] = rem
            imp_sell[:, r0:r0 + rc] += sums[..., n_periods]
    return imp.view(n, r, nb), imp_sell


def sums_monthdot_pre_plain(load, gen, sell, bucket_id, scales, *, n_periods=2,
                            c_pad=8, prebuilt=None):
    """Plain version of :func:`sums_monthdot_pre`."""
    m = _mask_for(sell, bucket_id, n_periods, c_pad, prebuilt, load)
    return mask_product_plain(load, gen, m, scales, n_periods=n_periods)


def sums_mnet_plain(load, gen, sell, bucket_id, scales, *, n_periods=2, c_pad=8,
                    hi=False, prebuilt=None):
    """Plain version of :func:`sums_mnet`: ``(1, -s) x (load; gen)`` is
    ``load - s * gen``, so in float32 it is :func:`mask_product_plain`
    (``hi`` changes only the kernel's precision)."""
    return sums_monthdot_pre_plain(load, gen, sell, bucket_id, scales,
                                   n_periods=n_periods, c_pad=c_pad,
                                   prebuilt=prebuilt)


def sums_variant_plain(load, gen, sell, bucket_id, scales, *, n_periods=2,
                       b_pad=128, build="onehot", dot="dot", net="fma",
                       m_hbm=None, h_chunk=None):
    """Plain version of :func:`sums_variant`, every form (``h_chunk`` is
    checked and changes no value: chunks only reorder the sums)."""
    n, r = scales.shape
    _check_variant(n_periods, b_pad, build, dot, net, m_hbm, h_chunk, n,
                   scales.device)
    nb = MONTHS * n_periods
    f32 = dict(dtype=torch.float32, device=scales.device)
    acc = torch.zeros((n, r, b_pad), **f32)
    hc = min(HOURS, bk._scale_chunk(n, max(r, b_pad)))
    for h0 in range(0, HOURS, hc):
        h1 = min(HOURS, h0 + hc)
        if build == "onehot":
            m = torch.zeros((n, h1 - h0, b_pad), **f32)
            m.scatter_(2, bucket_id[:, h0:h1, None].long(), 1.0)
            m[:, :, b_pad - 1] = sell[:, h0:h1]
        elif build == "const":
            m = torch.full((n, h1 - h0, b_pad), CONST_M, **f32)
        else:
            m = m_hbm[:, h0:h1]
        if net == "fma":
            pos = _pos(load, gen, scales, h0, h1)
        else:
            pos = torch.clamp_min(load[:, None, h0:h1], 0.0).expand(n, r, h1 - h0)
        if dot == "dot":
            acc += torch.bmm(pos, m)
        else:
            acc += pos.sum(dim=2, keepdim=True) + m[:, :, 0].sum(dim=1)[:, None, None]
    return acc[..., :nb].contiguous(), acc[..., b_pad - 1].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_call(fn_name: str, key: str, load, gen, sell, bucket_id, scales,
                 n_periods: int, c_tail: tuple, kwargs: dict):
    """Checks the operands, launches ``fn_name`` (streams, bucket ids,
    scales, month offsets, the two outputs, n, r, n_periods, then
    ``c_tail``) and counts the launch under ``key``."""
    n, r = bk._check_kernel_inputs((load, gen, sell), (bucket_id,), scales, HOURS)
    imp, imp_sell = bk._sums_buffers(n, r, n_periods, False, scales.device)[:2]
    if n and r:
        bk._launch(fn_name, scales, bk._ptr(load), bk._ptr(gen), bk._ptr(sell),
                   bk._ptr(bucket_id), bk._ptr(scales),
                   bk._offsets_arg(FULL_OFFSETS, HOURS), bk._ptr(imp),
                   bk._ptr(imp_sell), n, r, n_periods, *c_tail)
        bk._count(key, (load, gen, sell, bucket_id, scales, kwargs))
    return imp, imp_sell


def sums_monthmask(load, gen, sell, bucket_id, scales, *, n_periods=2):
    """Month-masked bucket sums, one agent per block (see the module
    docstring): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU one."""
    _check_periods(n_periods)
    bk._check_ids(bucket_id)
    kwargs = dict(n_periods=n_periods)
    if scales.device.type == "cpu":
        return sums_monthmask_plain(load, gen, sell, bucket_id, scales, **kwargs)
    return _kernel_call("microbench_monthmask", "monthmask", load, gen, sell,
                        bucket_id, scales, n_periods, (), kwargs)


def sums_monthmask_g(load, gen, sell, bucket_id, scales, *, n_periods=2,
                     g_block=8):
    """Month-masked bucket sums with ``g_block`` agents per block: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU one."""
    _check_periods(n_periods)
    _check_g_block(scales.shape[0], g_block)
    bk._check_ids(bucket_id)
    kwargs = dict(n_periods=n_periods, g_block=g_block)
    if scales.device.type == "cpu":
        return sums_monthmask_g_plain(load, gen, sell, bucket_id, scales, **kwargs)
    return _kernel_call("microbench_monthmask_g", "monthmask_g", load, gen, sell,
                        bucket_id, scales, n_periods, (g_block,), kwargs)


def sums_monthdot(load, gen, sell, bucket_id, scales, *, n_periods=2):
    """Month-blocked tensor-core bucket sums against a positional M: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU one."""
    _check_periods(n_periods)
    bk._check_ids(bucket_id)
    kwargs = dict(n_periods=n_periods)
    if scales.device.type == "cpu":
        return sums_monthdot_plain(load, gen, sell, bucket_id, scales, **kwargs)
    return _kernel_call("microbench_monthdot", "monthdot", load, gen, sell,
                        bucket_id, scales, n_periods, (), kwargs)


def sums_variant(load, gen, sell, bucket_id, scales, *, n_periods=2, b_pad=128,
                 build="onehot", dot="dot", net="fma",
                 m_hbm: Optional[torch.Tensor] = None, h_chunk=None):
    """The one-hot tensor-core kernel with its stages switched (see the
    module docstring): the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one."""
    hc = _check_variant(n_periods, b_pad, build, dot, net, m_hbm, h_chunk,
                        scales.shape[0], scales.device)
    bk._check_ids(bucket_id)
    kwargs = dict(n_periods=n_periods, b_pad=b_pad, build=build, dot=dot, net=net,
                  m_hbm=m_hbm, h_chunk=h_chunk)
    if scales.device.type == "cpu":
        return sums_variant_plain(load, gen, sell, bucket_id, scales, **kwargs)
    tail = (b_pad, hc, BUILDS.index(build), DOTS.index(dot), NETS.index(net),
            bk._ptr(m_hbm))
    return _kernel_call("microbench_variant", "variant", load, gen, sell,
                        bucket_id, scales, n_periods, tail, kwargs)


def _mask_for(sell, bucket_id, n_periods: int, c_pad: int, prebuilt, load):
    """The prebuilt M, checked, or M built now."""
    _check_c_pad(n_periods, c_pad)
    if prebuilt is None:
        bk._check_ids(bucket_id)
        return build_mask_cols(sell, bucket_id % n_periods, n_periods, c_pad)
    _check_mask(prebuilt, load, c_pad)
    return prebuilt


def _mask_product(fn_name: str, key: str, load, gen, m, scales, n_periods: int,
                  c_tail: tuple, kwargs: dict):
    """Checks the operands, launches ``fn_name`` (load, gen, M, scales,
    month offsets, the two outputs, n, r, n_periods, c_pad, then
    ``c_tail``) and counts the launch under ``key``."""
    n, r = bk._check_kernel_inputs((load, gen), (), scales, HOURS)
    imp, imp_sell = bk._sums_buffers(n, r, n_periods, False, scales.device)[:2]
    if n and r:
        bk._launch(fn_name, scales, bk._ptr(load), bk._ptr(gen), bk._ptr(m),
                   bk._ptr(scales), bk._offsets_arg(FULL_OFFSETS, HOURS),
                   bk._ptr(imp), bk._ptr(imp_sell), n, r, n_periods, m.shape[1],
                   *c_tail)
        bk._count(key, (load, gen, m, scales, kwargs))
    return imp, imp_sell


def _check_pre_operands(load, gen, m, n_periods: int) -> None:
    """What the prebuilt-mask kernels take, on every device: float32
    load and gen (the variants read no narrow streams) and a contiguous
    float32 M [N, c_pad, 8760]."""
    _check_c_pad(n_periods, m.shape[1])
    for t in (load, gen):
        if t.dtype != torch.float32:
            raise TypeError(f"the prebuilt-mask kernels read float32 streams, "
                            f"got {t.dtype}")
    _check_mask(m, load, m.shape[1])


def monthdot_pre_sums(load, gen, m, scales, *, n_periods=2):
    """The prebuilt-mask product over M [N, c_pad, 8760]: the CUDA kernel
    (``microbench_monthdot_pre``) on a CUDA tensor, the plain version on
    a CPU one."""
    _check_pre_operands(load, gen, m, n_periods)
    if scales.device.type == "cpu":
        return mask_product_plain(load, gen, m, scales, n_periods=n_periods)
    return _mask_product("microbench_monthdot_pre", "monthdot_pre", load, gen, m,
                         scales, n_periods, (), dict(n_periods=n_periods))


def mnet_sums(load, gen, m, scales, *, n_periods=2, hi=False):
    """The rank-1-net prebuilt-mask product (``microbench_mnet``, 3xTF32
    when ``hi``) on a CUDA tensor, the plain version on a CPU one;
    launches count under ``"mnet_hi"`` when ``hi``, else ``"mnet"``."""
    _check_pre_operands(load, gen, m, n_periods)
    if scales.device.type == "cpu":
        return mask_product_plain(load, gen, m, scales, n_periods=n_periods)
    return _mask_product("microbench_mnet", "mnet_hi" if hi else "mnet", load, gen,
                         m, scales, n_periods, (int(hi),),
                         dict(n_periods=n_periods, hi=hi))


def sums_monthdot_pre(load, gen, sell, bucket_id, scales, *, n_periods=2, c_pad=8,
                      prebuilt: Optional[torch.Tensor] = None):
    """Month-blocked tensor-core bucket sums against prebuilt mask columns
    (see the module docstring); ``prebuilt``: M from
    :func:`build_mask_cols`, else built here from ``sell`` and the bucket
    ids."""
    m = _mask_for(sell, bucket_id, n_periods, c_pad, prebuilt, load)
    return monthdot_pre_sums(load, gen, m, scales, n_periods=n_periods)


def sums_mnet(load, gen, sell, bucket_id, scales, *, n_periods=2, c_pad=8,
              hi=False, prebuilt: Optional[torch.Tensor] = None):
    """Bucket sums with a rank-1 tensor-core net and the prebuilt-mask
    product, in TF32, or in 3xTF32 with ``hi`` (see the module
    docstring). ``prebuilt`` as in :func:`sums_monthdot_pre` (the JAX
    function always builds M inside the call)."""
    m = _mask_for(sell, bucket_id, n_periods, c_pad, prebuilt, load)
    return mnet_sums(load, gen, m, scales, n_periods=n_periods, hi=hi)
