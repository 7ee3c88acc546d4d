"""Carry weights and state across: plain numpy dicts in, the port's
containers out.

Each function below takes a dict of field name -> ``np.ndarray`` (nested
dataclass fields as nested dicts, static ints as ints) — for example
the fields of a JAX package container read with ``dataclasses.fields``
and ``np.asarray`` — and returns the port's container on ``device``.
Float64 arrays become float32 and int64 arrays int32, as under the JAX
package's default 32-bit mode. A field the port does not carry must be
absent or ``None``, else it raises. :func:`to_numpy_dict` is the inverse.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from dgen_tpu_torch.config import resolve_device
from dgen_tpu_torch.models.agents import AgentTable, ProfileBank
from dgen_tpu_torch.models.market import MarketState
from dgen_tpu_torch.models.scenario import ScenarioInputs
from dgen_tpu_torch.models.simulation import SimCarry
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


def to_numpy_dict(obj) -> dict:
    """Field name -> host numpy array of a dataclass container (nested
    dataclasses as nested dicts, non-array fields as they are). Works on
    any container whose leaves ``np.asarray`` can read, or tensors."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy_dict(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif v is None or isinstance(v, (int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out
