"""Carry weights and state across: plain numpy dicts in, the port's
containers out.

Each function below takes a dict of field name -> ``np.ndarray`` (nested
dataclass fields as nested dicts, static ints as ints) — for example
the fields of a JAX package container read with ``dataclasses.fields``
and ``np.asarray`` — and returns the port's container on ``device``.
Float64 arrays become float32 and int64 arrays int32, as under the JAX
package's default 32-bit mode. A field the port does not carry must be
absent or ``None``, else it raises. :func:`to_numpy_dict` is the inverse
(of NamedTuple containers, such as :class:`DemandTariff`, too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.grad.newton import NewtonSizeResult
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank
from dgen_tpu_torch.models.market import MarketState
from dgen_tpu_torch.models.scenario import ScenarioInputs
from dgen_tpu_torch.models.simulation import SimCarry
from dgen_tpu_torch.ops.demand import DemandTariff
from dgen_tpu_torch.ops.cashflow import IncentiveParams
from dgen_tpu_torch.ops.tariff import TariffBank

#: dataclass type of each nested container field
_NESTED = {"incentives": IncentiveParams, "market": MarketState}


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(arr).to(device)


def _build(cls, d: Mapping[str, Any], device: torch.device):
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [k for k, v in d.items() if k not in names and v is not None]
    if extra:
        raise ValueError(f"{cls.__name__} does not carry {sorted(extra)}")
    vals = {}
    for f in dataclasses.fields(cls):
        if f.name not in d or d[f.name] is None:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__} needs field '{f.name}'")
            continue
        v = d[f.name]
        if f.name in _NESTED:
            vals[f.name] = _build(_NESTED[f.name], v, device)
        elif isinstance(v, (int, np.integer)) and f.name == "n_states":
            vals[f.name] = int(v)
        else:
            vals[f.name] = _tensor(v, device)
    return cls(**vals)


def agent_table(d: Mapping[str, Any], device="cuda") -> AgentTable:
    return _build(AgentTable, d, resolve_device(device))


def profile_bank(d: Mapping[str, Any], device="cuda") -> ProfileBank:
    return _build(ProfileBank, d, resolve_device(device))


def tariff_bank(d: Mapping[str, Any], device="cuda") -> TariffBank:
    return _build(TariffBank, d, resolve_device(device))


def scenario_inputs(d: Mapping[str, Any], device="cuda") -> ScenarioInputs:
    return _build(ScenarioInputs, d, resolve_device(device))


def sim_carry(d: Mapping[str, Any], device="cuda") -> SimCarry:
    return _build(SimCarry, d, resolve_device(device))


def newton_size_result(d: Mapping[str, Any], device="cuda") -> NewtonSizeResult:
    return _build(NewtonSizeResult, d, resolve_device(device))


def demand_tariff(d: Mapping[str, Any], device="cuda") -> DemandTariff:
    """A :class:`DemandTariff` (one tariff, a bank or per-agent leaves)
    from its five leaves."""
    missing = [k for k in DemandTariff._fields if k not in d]
    extra = [k for k in d if k not in DemandTariff._fields]
    if missing or extra:
        raise ValueError(f"DemandTariff needs {list(DemandTariff._fields)}; "
                         f"missing {missing}, not carried {extra}")
    dev = resolve_device(device)
    return DemandTariff(*(_tensor(d[k], dev) for k in DemandTariff._fields))


#: the calibration's parameter names (dgen_tpu_torch.grad.calibrate)
CALIBRATION_PARAMS = ("log_p", "log_q", "mms_elast")


def calibration_params(d: Mapping[str, Any], device="cuda") -> dict:
    """The calibration's parameter dict (``log_p``, ``log_q`` and
    optionally ``mms_elast``, each a scalar) as 0-d float32 tensors."""
    extra = [k for k in d if k not in CALIBRATION_PARAMS]
    if extra or not {"log_p", "log_q"} <= set(d):
        raise ValueError(f"calibration parameters are {CALIBRATION_PARAMS} (the "
                         f"first two required), got {sorted(d)}")
    dev = resolve_device(device)
    return {k: _tensor(np.float32(np.asarray(v).reshape(())), dev)
            for k, v in d.items()}


def to_numpy_dict(obj) -> dict:
    """Field name -> host numpy array of a dataclass or NamedTuple
    container (nested dataclasses as nested dicts, non-array fields as
    they are). Works on any container whose leaves ``np.asarray`` can
    read, or tensors."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = obj._asdict().items()
    else:
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    out = {}
    for name, v in items:
        if dataclasses.is_dataclass(v):
            out[name] = to_numpy_dict(v)
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        elif v is None or isinstance(v, (int, float, str)):
            out[name] = v
        else:
            out[name] = np.asarray(v)
    return out
