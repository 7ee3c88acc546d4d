"""Hour-lane layouts, night sums and packed streams of the PyTorch port
against the JAX package's (``dgen_tpu/ops/billpallas.py``) on the CPU.

Lane maps (``idx``, ``valid``, ``night``, ``seg_lens``) must be equal bit
for bit, so the port compacts exactly when and where the JAX package
does. Night sums and packed lanes: rtol 1e-6 (the same float32 products
summed by two libraries). The JAX package's full-hour lanes are
month-padded 768-lane slots; the port's are the plain 8760-hour order,
so full-hour packs are compared on the JAX slots' real lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgen_tpu.io import synth as jsynth
from dgen_tpu.ops import billpallas as jbp
from dgen_tpu.ops import tariff as jtariff
from dgen_tpu_torch.io import synth as tsynth
from dgen_tpu_torch.ops import billkernels as tbk
from dgen_tpu_torch.ops import layout as tlay

N = 12
P = 3


def _banks():
    """Generation banks: the synthetic generator's (compactable), the
    same with three winter nights lit, one that generates in every hour
    (no layout) and an empty one."""
    synth = jsynth.make_solar_cf_profiles(8, seed=1)
    lit = synth.copy()
    lit[0, [10, 30, 8000]] = 0.01
    return {"synth": synth, "lit": lit,
            "always": np.full((2, 8760), 0.1, np.float32),
            "dark": np.zeros((2, 8760), np.float32)}


@pytest.mark.parametrize("bank", ["synth", "lit", "always", "dark"])
def test_layout_lane_maps_equal(bank):
    gen = _banks()[bank]
    ref = jbp.daylight_layout(gen)
    got = tlay.daylight_layout(gen)
    assert (ref is None) == (got is None)
    if ref is None:
        assert bank == "always"
        return
    for lay_r, lay_g in ((ref, got), (ref.uniform(), got.uniform())):
        assert lay_g.seg_lens == lay_r.seg_lens
        for k in ("idx", "valid", "night"):
            a, b = getattr(lay_r, k), getattr(lay_g, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)
        assert lay_g.n_lanes == lay_r.n_lanes
        assert lay_g.offsets == tlay.seg_offsets(lay_r.seg_lens)


def test_synth_bank_compacts_and_uniform_pads():
    """The generator's bank compacts, and uniform() pads every month to
    the longest segment without moving an hour."""
    lay = tlay.daylight_layout(tsynth.make_solar_cf_profiles(8, seed=1))
    u = lay.uniform()
    assert lay.n_lanes < 8760 and len(set(u.seg_lens)) == 1
    assert u.n_lanes == 12 * max(lay.seg_lens)
    np.testing.assert_array_equal(np.sort(u.idx[u.valid > 0]),
                                  np.sort(lay.idx[lay.valid > 0]))
    assert int(lay.valid.sum()) + int(lay.night.sum()) == 8760
    assert u.uniform() is u


def test_full_offsets_are_the_calendar_months():
    hm = np.asarray(jtariff.hour_month_map())
    bounds = [0] + [int(np.nonzero(hm == m)[0][-1]) + 1 for m in range(12)]
    assert tlay.FULL_OFFSETS == tuple(bounds)


@pytest.fixture(scope="module")
def streams():
    """Seeded [N, 8760] streams with the synthetic generation shape, TOU
    periods drawn per hour, and both packages' copies of them."""
    rng = np.random.default_rng(4)
    gen_bank = jsynth.make_solar_cf_profiles(8, seed=1)
    gen = gen_bank[rng.integers(0, 8, N)] * np.float32(0.96)
    load = rng.uniform(0.2, 3.0, (N, 8760)).astype(np.float32)
    sell = rng.uniform(0.01, 0.1, (N, 8760)).astype(np.float32)
    period = rng.integers(0, P, (N, 8760)).astype(np.int32)
    bucket = (jtariff.hour_month_map()[None, :] * P + period).astype(np.int32)
    sell_b = rng.uniform(0.01, 0.1, (N, 8760)).astype(np.float32)
    bucket_b = (bucket + 1) % (12 * P)
    lay_j = jbp.daylight_layout(gen_bank)
    lay_t = tlay.daylight_layout(gen_bank)
    np_streams = (load, gen, sell, bucket, sell_b, bucket_b)
    return dict(
        j=tuple(jnp.asarray(a) for a in np_streams),
        t=tuple(torch.from_numpy(a) for a in np_streams),
        lay_j=lay_j, lay_t=lay_t,
    )


def _close(got, ref, rtol=1e-6, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("signed", [False, True])
def test_night_sums_match(streams, signed):
    load, _, sell, bucket, _, _ = streams["j"]
    ref_i, ref_s = jbp._night_sums(load, sell, bucket, streams["lay_j"].night, P,
                                   signed)
    tload, _, tsell, tbucket, _, _ = streams["t"]
    night = torch.from_numpy(np.array(streams["lay_t"].night))
    got_i, got_s = tbk.night_sums(tload, tsell, tbucket, night, P, signed)
    for ref, got in ((ref_i, got_i), (ref_s, got_s)):
        if ref is None:
            assert got is None
            continue
        _close(got[0], np.asarray(ref)[:, :12 * P])
        _close(got[1], np.asarray(ref)[:, jbp.SELL_COL])
    # night-only: a lane-free bank would have every hour in the night
    assert float(got_i[0].sum()) > 0.0


@pytest.mark.parametrize("compacted", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_packs_match(streams, compacted, pair):
    load, gen, sell, bucket, sell_b, bucket_b = streams["j"]
    tl, tg, ts, tb, tsb, tbb = streams["t"]
    lay_j = streams["lay_j"].uniform() if compacted else None
    lay_t = streams["lay_t"].uniform() if compacted else None
    extra_j = dict(sell_b=sell_b, bucket_b=bucket_b) if pair else {}
    extra_t = dict(sell_b=tsb, bucket_b=tbb) if pair else {}
    ref = jbp.pack_streams(load, gen, sell, bucket, 12 * P, layout=lay_j, **extra_j)
    got = tbk.pack_streams(tl, tg, ts, tb, 12 * P, layout=lay_t, **extra_t)
    lanes = ["load", "gen", "sell", "period"] + (["sell_b", "period_b"] if pair else [])
    real = slice(None) if compacted else jbp._MONTH_VALID > 0
    for k in lanes:
        r, g = np.asarray(getattr(ref, k))[:, real], getattr(got, k)
        assert tuple(g.shape) == r.shape, k
        if k.startswith("period"):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), r, err_msg=k)
        else:
            _close(g, r)
    for k in ("night_imp", "night_imp_b"):
        r, g = getattr(ref, k), getattr(got, k)
        assert (r is None) == (g is None), k
        if r is not None:
            _close(g[0], np.asarray(r)[:, :12 * P])
            _close(g[1], np.asarray(r)[:, jbp.SELL_COL])
