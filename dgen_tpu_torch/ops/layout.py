"""Hour-lane layouts of the bucket-sums kernels (port of the layout part
of ``dgen_tpu/ops/billpallas.py``).

The kernels reduce ``[N, L]`` lanes month by month, with month ``m`` in
lanes ``[offsets[m], offsets[m + 1])``. Two layouts exist:

* **full-hour**: the plain 8760-hour order, month offsets at the calendar
  month boundaries (:data:`FULL_OFFSETS`);
* **daylight-compacted** (:class:`DaylightLayout`): only the hours where
  some generation profile of the bank is nonzero, month by month, each
  month padded with zero lanes to a multiple of 128. Wherever
  ``gen == 0``, ``relu(load - s * gen) == relu(load)`` for every scale
  ``s``, so the night hours' bucket sums do not depend on the scale: they
  are computed once (``billkernels.night_sums``) and added back.

The lane maps (segments of 128 lanes, "no layout" when compaction saves
nothing against twelve 768-lane months) are the JAX package's, so both
packages compact in the same cases onto the same lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgen_tpu_torch.ops.tariff import HOURS, MONTH_HOURS, MONTHS, hour_month_map

#: month offsets of the full-hour layout, in lanes
FULL_OFFSETS = tuple(int(h) for h in MONTH_HOURS)

#: lanes a compacted month segment is padded to a multiple of
SEG_QUANTUM = 128
#: a compacted layout is kept only when it has fewer lanes than twelve
#: 768-lane months (the JAX package's full layout)
_NO_GAIN_LANES = 12 * 768


def seg_offsets(seg_lens) -> tuple:
    """The 13 lane offsets of consecutive month segments."""
    return tuple(int(x) for x in np.concatenate([[0], np.cumsum(seg_lens)]))


@dataclasses.dataclass(frozen=True, eq=False)
class DaylightLayout:
    """Compacted hour layout: month ``m``'s daylight hours (union over
    the generation bank) occupy lanes ``[offsets[m], offsets[m] +
    seg_lens[m])``, zero-filled past the month's hour count."""

    idx: np.ndarray    # [L] int32 gather into the 8760-hour axis
    valid: np.ndarray  # [L] float32, 1 = real daylight lane
    night: np.ndarray  # [8760] float32, 1 = hour with no generation
    seg_lens: tuple

    def __post_init__(self):
        for a in (self.idx, self.valid, self.night):
            a.setflags(write=False)
        object.__setattr__(self, "_device_maps", {})

    @property
    def n_lanes(self) -> int:
        return int(sum(self.seg_lens))

    @property
    def offsets(self) -> tuple:
        return seg_offsets(self.seg_lens)

    def uniform(self) -> "DaylightLayout":
        """This layout with every month padded to the longest month's
        segment (the JAX stream engine's uniform-block form)."""
        seg = max(self.seg_lens)
        if all(s == seg for s in self.seg_lens):
            return self
        idx = np.zeros(MONTHS * seg, np.int32)
        valid = np.zeros(MONTHS * seg, np.float32)
        off = 0
        for m, ln in enumerate(self.seg_lens):
            cnt = int(np.sum(self.valid[off:off + ln]))
            idx[m * seg:m * seg + cnt] = self.idx[off:off + cnt]
            valid[m * seg:m * seg + cnt] = 1.0
            off += ln
        return DaylightLayout(idx=idx, valid=valid, night=self.night.copy(),
                              seg_lens=(seg,) * MONTHS)

    def device_maps(self, device) -> tuple:
        """(idx int64, valid float32, night float32) tensors on
        ``device``, made once per device."""
        dev = torch.device(device)
        maps = self._device_maps.get(dev)
        if maps is None:
            maps = (torch.from_numpy(self.idx.astype(np.int64)).to(dev),
                    torch.from_numpy(np.array(self.valid)).to(dev),
                    torch.from_numpy(np.array(self.night)).to(dev))
            self._device_maps[dev] = maps
        return maps


def daylight_layout(gen_bank: np.ndarray) -> Optional[DaylightLayout]:
    """Union-daylight layout of a ``[*, 8760]`` generation bank (host
    numpy), or None when compaction saves nothing."""
    day = np.any(np.asarray(gen_bank) > 0.0, axis=0)
    if day.shape != (HOURS,):
        raise ValueError(f"gen bank must have a trailing {HOURS} axis")
    hm = hour_month_map()
    seg_lens = []
    for m in range(MONTHS):
        count = int(np.sum(day[hm == m]))
        seg_lens.append(max(SEG_QUANTUM, -(-count // SEG_QUANTUM) * SEG_QUANTUM))
    if sum(seg_lens) >= _NO_GAIN_LANES:
        return None
    n_lanes = sum(seg_lens)
    idx = np.zeros(n_lanes, np.int32)
    valid = np.zeros(n_lanes, np.float32)
    off = 0
    for m, seg in enumerate(seg_lens):
        hrs = np.nonzero((hm == m) & day)[0]
        idx[off:off + len(hrs)] = hrs
        valid[off:off + len(hrs)] = 1.0
        off += seg
    return DaylightLayout(idx=idx, valid=valid, night=(~day).astype(np.float32),
                          seg_lens=tuple(seg_lens))
