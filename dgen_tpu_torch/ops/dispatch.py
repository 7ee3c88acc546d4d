"""Behind-the-meter battery dispatch (port of ``dgen_tpu/ops/dispatch.py``).

Greedy self-consumption: per hour, charge from PV surplus only (up to
power and headroom limits), discharge to unmet load only (up to power
and available energy). Two forms, as in the JAX package:

  * ``impl="scan"`` (default): the sequential recursion. On a CUDA tensor
    it is the hand-written kernel ``csrc/battery_dispatch.cu`` (one thread
    per agent steps the state of charge, helper warps of its block do the
    rest of each hour; equal to the plain loop bit for bit); on a CPU
    tensor it is
    :func:`dispatch_battery_plain`, the JAX ``lax.scan`` as a Python loop
    over ``[N]`` tensors.
  * ``impl="pscan"``: the saturating-accumulator parallel prefix (the JAX
    package's measured negative result), plain PyTorch on either device:
    a log-step prefix over :func:`_compose_clamp`.

The kernel counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

# battery energy = PV kW / 0.8 (kWh), power = energy / 2 (kW)
PV_TO_BATT_RATIO = 0.8
BATT_CAPACITY_TO_POWER_RATIO = 2.0
SOC_MIN_FRAC = 0.10
SOC_INIT_FRAC = 0.30
#: round-trip efficiency when no trajectory is supplied
DEFAULT_RT_EFF = 0.9216

IMPLS = ("scan", "pscan")

#: launches of the dispatch kernel since the last :func:`reset_launches`
LAUNCHES = {"dispatch": 0}


def reset_launches() -> None:
    LAUNCHES["dispatch"] = 0


def batt_size_from_pv(system_kw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(batt_kw, batt_kwh) at the fixed PV ratio."""
    batt_kwh = system_kw / PV_TO_BATT_RATIO
    batt_kw = batt_kwh / BATT_CAPACITY_TO_POWER_RATIO
    return batt_kw, batt_kwh


@dataclasses.dataclass(frozen=True)
class DispatchResult:
    system_out: torch.Tensor   # [N, 8760] net system output at the meter
    soc: torch.Tensor          # [N, 8760] state of charge after each hour
    charge: torch.Tensor       # [N, 8760] PV -> battery
    discharge: torch.Tensor    # [N, 8760] battery -> load


def _battery_params(batt_kwh: torch.Tensor, rt_eff: torch.Tensor):
    """(soc_min, soc_init, eta) ``[N]``: the floor, the starting state of
    charge and the one-way efficiency, computed once here so that the
    kernel and the plain loop start from the same bits."""
    return (batt_kwh * SOC_MIN_FRAC, batt_kwh * SOC_INIT_FRAC,
            torch.sqrt(rt_eff.to(torch.float32)))


def dispatch_battery_plain(load: torch.Tensor, gen: torch.Tensor,
                           batt_kw: torch.Tensor, batt_kwh: torch.Tensor,
                           rt_eff: torch.Tensor) -> DispatchResult:
    """Plain version of the dispatch kernel: the JAX ``lax.scan`` as an
    H-step loop over ``[N]`` tensors, each step's operations in the
    kernel's order; the parts of each step that do not depend on the
    state of charge are computed for all hours before the loop."""
    soc_min, soc, eta = _battery_params(batt_kwh, rt_eff)
    # hour-major so each step reads and writes one contiguous row
    surplus = torch.minimum(torch.clamp_min(gen - load, 0.0), batt_kw[:, None]).T.contiguous()
    deficit = torch.minimum(torch.clamp_min(load - gen, 0.0), batt_kw[:, None]).T.contiguous()
    hours = load.shape[1]
    soc_h = torch.empty_like(surplus)
    charge_h = torch.empty_like(surplus)
    discharge_h = torch.empty_like(surplus)
    for t in range(hours):
        charge = torch.minimum(surplus[t], torch.clamp_min(batt_kwh - soc, 0.0) / eta,
                               out=charge_h[t])
        discharge = torch.minimum(deficit[t], torch.clamp_min(soc - soc_min, 0.0) * eta,
                                  out=discharge_h[t])
        soc = torch.sub(soc + charge * eta, discharge / eta, out=soc_h[t])
    charge = charge_h.T
    discharge = discharge_h.T
    system_out = (gen - charge + discharge).contiguous()
    return DispatchResult(system_out=system_out, soc=soc_h.T, charge=charge,
                          discharge=discharge)


def _compose_clamp(f, g):
    """Composition of add-then-clamp maps, f applied first:
    ``(g o f)(x) = clamp(x + af + ag, lo', hi')``; associative."""
    af, lf, hf = f
    ag, lg, hg = g
    a = af + ag
    hi = torch.minimum(hg, torch.maximum(lg, hf + ag))
    lo = torch.minimum(hi, torch.maximum(lg, lf + ag))
    return a, lo, hi


def _dispatch_pscan(load, gen, batt_kw, batt_kwh, rt_eff) -> DispatchResult:
    """The state-of-charge recursion as a saturating-accumulator prefix:
    with ``soc_min <= soc <= kwh`` the step is ``soc_t = clamp(soc_{t-1} +
    a_t, soc_min, kwh)`` with ``a_t`` independent of soc, and the prefix of
    the composed clamps (Hillis-Steele, ceil(log2 H) sweeps over the hour
    axis) gives every hour's soc at once."""
    soc_min, soc0, eta = _battery_params(batt_kwh, rt_eff)
    surplus = torch.clamp_min(gen - load, 0.0)
    deficit = torch.clamp_min(load - gen, 0.0)
    kw = batt_kw[:, None]
    e = eta[:, None]
    a = torch.minimum(surplus, kw) * e - torch.minimum(deficit, kw) / e
    lo = soc_min[:, None].expand_as(a).clone()
    hi = batt_kwh[:, None].expand_as(a).clone()
    hours = a.shape[1]
    d = 1
    while d < hours:
        # element t takes (element t - d) o (element t): the earlier map first
        na, nlo, nhi = _compose_clamp((a[:, :-d], lo[:, :-d], hi[:, :-d]),
                                      (a[:, d:], lo[:, d:], hi[:, d:]))
        a = torch.cat([a[:, :d], na], dim=1)
        lo = torch.cat([lo[:, :d], nlo], dim=1)
        hi = torch.cat([hi[:, :d], nhi], dim=1)
        d *= 2
    soc0 = soc0[:, None]
    soc = torch.minimum(torch.maximum(soc0 + a, lo), hi)
    dsoc = torch.diff(soc, dim=1, prepend=soc0)
    charge = torch.clamp_min(dsoc, 0.0) / e
    discharge = torch.clamp_min(-dsoc, 0.0) * e
    system_out = gen - charge + discharge
    return DispatchResult(system_out=system_out, soc=soc, charge=charge,
                          discharge=discharge)


def _dispatch_kernel(load, gen, batt_kw, batt_kwh, rt_eff) -> DispatchResult:
    """Launches ``csrc/battery_dispatch.cu`` on the current stream of the
    tensors' device; raises on what the kernel does not take (an input
    that requires a derivative among it: the kernel has no backward) and
    if the launch was refused."""
    from dgen_tpu_torch.ops import _build

    from dgen_tpu_torch.ops.billkernels import check_no_grad

    check_no_grad("battery_dispatch", (load, gen, batt_kw, batt_kwh, rt_eff))
    n, hours = load.shape
    params = (batt_kw, batt_kwh, *_battery_params(batt_kwh, rt_eff))
    for name, x, shape in ([("load", load, (n, hours)), ("gen", gen, (n, hours))]
                           + [("battery parameter", p, (n,)) for p in params]):
        if x.device != load.device:
            raise ValueError(f"{name} on {x.device}, load on {load.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = [torch.empty((n, hours), dtype=torch.float32, device=load.device)
            for _ in range(4)]
    if n and hours:
        with torch.cuda.device(load.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _build.library().battery_dispatch(
                *(ctypes.c_void_p(t.data_ptr()) for t in (load, gen, *params, *outs)),
                n, hours, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"battery_dispatch launch failed: CUDA error {rc}")
        LAUNCHES["dispatch"] += 1
    return DispatchResult(*outs)


def dispatch_battery(load: torch.Tensor, gen: torch.Tensor, batt_kw: torch.Tensor,
                     batt_kwh: torch.Tensor, rt_eff: torch.Tensor,
                     impl: str = "scan") -> DispatchResult:
    """Dispatch ``[N, H]`` load/generation through batteries of
    ``batt_kw`` / ``batt_kwh`` ``[N]`` with round-trip efficiency
    ``rt_eff`` ``[N]`` (split evenly into one-way efficiencies).
    ``system_out = gen - charge + discharge`` is what the bill engine
    prices as the system's meter contribution. ``impl="scan"`` runs the
    kernel on a CUDA tensor and :func:`dispatch_battery_plain` on a CPU
    one; ``"pscan"`` the parallel prefix on either."""
    if impl not in IMPLS:
        raise ValueError(f"unknown dispatch impl {impl!r}")
    if impl == "pscan":
        return _dispatch_pscan(load, gen, batt_kw, batt_kwh, rt_eff)
    if load.device.type == "cpu":
        return dispatch_battery_plain(load, gen, batt_kw, batt_kwh, rt_eff)
    return _dispatch_kernel(load.contiguous(), gen.contiguous(), batt_kw.contiguous(),
                            batt_kwh.contiguous(), rt_eff)
