"""DGPB1 profile-bank files (port of ``dgen_tpu/io/store.py``).

Large dense matrices (the 8760-hour load, solar-CF and wholesale banks)
live in flat binary files: the 6-byte magic ``DGPB1\\0``, a 2-byte
little-endian dtype code, then rows and cols as 8-byte little-endian
integers (a 24-byte header), then the row-major payload. Dtype codes:
0 float32, 1 bfloat16, 2 int8 codes followed by a per-row float32 scale
sidecar (value = scale[row] * code).

Reads and writes are numpy alone: the JAX package's ``ml_dtypes`` is not
needed (bfloat16 payloads are read as 16-bit integers and viewed as
``torch.bfloat16``; written bfloat16 is float32 rounded to nearest even,
as ``ml_dtypes`` rounds), and its native C++ reader is neither built nor
loaded. The files are byte for byte those the JAX package writes.
:func:`csv_to_bank` parses a numeric CSV into a float32 matrix with
numpy (the JAX package's fallback route; its native parser gives the
same values) and can persist it as a bank.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

_MAGIC = b"DGPB1\x00"
_HEADER = 24

_F32_CODE, _BF16_CODE, _INT8_CODE = 0, 1, 2
#: dtype code -> (numpy payload dtype, torch dtype the payload is viewed as)
_CODES = {
    _F32_CODE: (np.dtype("<f4"), torch.float32),
    _BF16_CODE: (np.dtype("<i2"), torch.bfloat16),
    _INT8_CODE: (np.dtype(np.int8), torch.int8),
}
_TORCH_TO_CODE = {t: c for c, (_, t) in _CODES.items()}


def atomic_write(path: str, write_fn) -> None:
    """Write ``path`` crash-consistently: ``write_fn(tmp_path)`` writes a
    temp sibling, then one ``os.replace`` publishes it (a reader sees the
    old file or the whole new one, never a torn one). The temp file is
    removed on failure."""
    tmp = f"{path}.tmp"
    ok = False
    try:
        write_fn(tmp)
        os.replace(tmp, path)
        ok = True
    finally:
        if not ok and os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _target_code(data: torch.Tensor, dtype: Optional[str]) -> int:
    if dtype is None:
        return _TORCH_TO_CODE.get(data.dtype, _F32_CODE)
    if dtype in ("f32", "float32"):
        return _F32_CODE
    if dtype in ("bf16", "bfloat16"):
        return _BF16_CODE
    if dtype in ("int8", "i8"):
        return _INT8_CODE
    raise ValueError(f"unsupported bank dtype {dtype!r} (f32 | bf16 | int8)")


def write_bank(path: str, data, dtype: Optional[str] = None,
               scales=None) -> None:
    """Persist a row-major [rows, cols] matrix (numpy array or tensor) as
    a DGPB1 bank file.

    ``dtype``: None keeps the data's own dtype (float32 unless it is
    already bfloat16 or int8); "bf16" rounds to bfloat16 on write;
    "int8" quantizes on write (``models.agents.quantize_rows``: per-row
    symmetric codes and a float32 scale sidecar); "f32" forces float32.
    ``scales``: the [rows] float32 factors, required when ``data`` is
    already int8 codes, and refused for any other bank."""
    from dgen_tpu_torch.models.agents import quantize_rows

    t = data.detach().cpu() if isinstance(data, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(data))
    if t.ndim != 2:
        raise ValueError("bank must be 2-D [rows, cols]")
    code = _target_code(t, dtype)
    if code == _INT8_CODE:
        if t.dtype == torch.int8:
            if scales is None:
                raise ValueError("int8 bank data needs its per-row f32 scales "
                                 "(write_bank(..., scales=...))")
            codes = t.numpy()
            scales = np.asarray(scales, dtype=np.float32)
        else:
            codes, scales = quantize_rows(t.float().numpy())
        if scales.shape != (codes.shape[0],):
            raise ValueError(f"scales must be [rows]={codes.shape[0]}, "
                             f"got {scales.shape}")
        payload = codes.tobytes() + scales.astype("<f4").tobytes()
    else:
        if scales is not None:
            raise ValueError("scales only apply to int8 banks")
        body = t.to(torch.float32)
        if code == _BF16_CODE:
            body = body.to(torch.bfloat16).view(torch.int16)
        payload = body.contiguous().numpy().astype(_CODES[code][0],
                                                   copy=False).tobytes()

    def _write(tmp_path: str) -> None:
        with open(tmp_path, "wb") as f:
            f.write(_MAGIC)
            f.write(code.to_bytes(2, "little"))
            f.write(int(t.shape[0]).to_bytes(8, "little"))
            f.write(int(t.shape[1]).to_bytes(8, "little"))
            f.write(payload)

    atomic_write(path, _write)


def read_bank_raw(path: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A DGPB1 bank in its stored representation, on the CPU: (bank,
    scales), the bank float32, bfloat16 or int8 codes, and ``scales`` the
    [rows] float32 sidecar of an int8 bank (None otherwise)."""
    with open(path, "rb") as f:
        head = f.read(_HEADER)
        if len(head) != _HEADER or head[:6] != _MAGIC:
            raise IOError(f"{path}: bad magic (not a DGPB1 file)")
        code = int.from_bytes(head[6:8], "little")
        if code not in _CODES:
            raise IOError(f"{path}: unsupported dtype code {code}")
        np_dtype, torch_dtype = _CODES[code]
        rows = int.from_bytes(head[8:16], "little")
        cols = int.from_bytes(head[16:24], "little")
        data = np.fromfile(f, dtype=np_dtype, count=rows * cols)
        if data.size != rows * cols:
            raise IOError(f"{path}: truncated payload ({data.size} of "
                          f"{rows * cols} values)")
        scales = None
        if code == _INT8_CODE:
            scales = np.fromfile(f, dtype="<f4", count=rows)
            if scales.size != rows:
                raise IOError(f"{path}: truncated int8 scale sidecar")
    bank = torch.from_numpy(data.reshape(rows, cols))
    if code == _BF16_CODE:
        bank = bank.view(torch_dtype)
    return bank, None if scales is None else torch.from_numpy(scales)


def read_bank(path: str) -> torch.Tensor:
    """A DGPB1 bank on the CPU in its stored dtype (float32 or bfloat16);
    an int8 bank comes back dequantized to float32 (``scale[row] *
    code``), as the JAX package's ``read_bank`` returns it."""
    bank, scales = read_bank_raw(path)
    if scales is not None:
        return bank.float() * scales[:, None]
    return bank


def csv_to_bank(
    csv_path: str,
    bank_path: Optional[str] = None,
    skip_header: bool = True,
    skip_cols: int = 0,
    n_threads: int = 0,
) -> np.ndarray:
    """Parse a numeric CSV into a float32 [rows, cols] matrix and, with
    ``bank_path``, persist it as a float32 bank (:func:`write_bank`).

    ``skip_header`` drops the first line; ``skip_cols`` drops leading id
    columns before parsing (they may be non-numeric). A row of another
    width than the first, a non-numeric cell or an empty body raises
    ``IOError``, as the JAX package's native parser refuses them.
    ``n_threads`` is accepted for the JAX package's signature and unused:
    the parse is numpy's, on one thread."""
    del n_threads
    usecols = None
    if skip_cols:
        # skip id columns BEFORE parsing (they may be non-numeric); numpy
        # then reads only the selected columns, so the row widths are
        # checked here
        with open(csv_path, "rb") as f:
            lines = f.read().splitlines()[1 if skip_header else 0:]
        widths = {line.count(b",") + 1 for line in lines if line.strip()}
        if len(widths) > 1:
            raise IOError(f"csv parse failed: {csv_path}: rows of {sorted(widths)} "
                          "columns")
        n_cols = widths.pop() if widths else 1
        if n_cols - skip_cols <= 0:
            raise ValueError("skip_cols leaves no data columns")
        usecols = range(skip_cols, n_cols)
    try:
        out = np.loadtxt(csv_path, delimiter=",", skiprows=1 if skip_header else 0,
                         dtype=np.float32, ndmin=2, usecols=usecols)
    except ValueError as e:
        raise IOError(f"csv parse failed: {csv_path}: {e}") from e
    if out.size == 0:
        raise IOError(f"csv parse failed: {csv_path}: empty csv body")
    if bank_path:
        write_bank(bank_path, out)
    return out
