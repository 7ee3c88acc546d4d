"""The port's URDB tooling (dgen_tpu_torch.io.urdb) against the JAX
package's (dgen_tpu.io.urdb): the six cases of tests/test_urdb.py, each
holding the port's output equal to the JAX function's on the same
record or portfolio (and the port's own checks of tests/test_urdb.py),
with the HTTP fetch injected."""

import json

import numpy as np
import pytest
import torch

from dgen_tpu.io import urdb as jurdb
from dgen_tpu_torch.io import urdb
from dgen_tpu_torch.ops.tariff import NET_METERING, normalize_tariff_spec

from test_urdb import RECORD


def _same(got, want):
    """Equal spec trees: the same keys, lists, and floats bit for bit."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, float):
        assert np.float64(got).tobytes() == np.float64(want).tobytes()
    else:
        assert got == want


def test_urdb_record_parses_and_compiles():
    energy, demand = urdb.urdb_rate_to_specs(RECORD)
    _same((energy, demand), jurdb.urdb_rate_to_specs(RECORD))
    assert energy["e_prices"][0][0] == pytest.approx(0.11)
    assert energy["e_levels"][0][0] == pytest.approx(500)
    assert energy["metering"] == NET_METERING
    dense = normalize_tariff_spec(energy)
    assert dense["price"].shape[0] == 2
    assert np.all(dense["wkday"][:, 12:20] == 1)
    assert demand["d_flat_prices"][0][5] == pytest.approx(7.5)
    assert demand["d_tou_prices"][0][1] == pytest.approx(11.0)


def test_urdb_out_of_range_periods_fall_back_to_zero():
    rec = dict(RECORD)
    rec["energyweekdayschedule"] = [[3] * 24] * 12   # period 3 undefined
    energy, demand = urdb.urdb_rate_to_specs(rec)
    _same((energy, demand), jurdb.urdb_rate_to_specs(rec))
    assert max(max(r) for r in energy["e_wkday_12by24"]) == 0


@pytest.mark.parametrize("record", [
    {"label": "empty"},
    {"fixedmonthlycharge": None, "fixedchargefirstmeter": 4.0, "metering": None},
    {"flatdemandstructure": [[{"rate": 0.0}]], "demandratestructure": [[{"rate": 0.0}]]},
    {"energyratestructure": [[{"rate": None, "adj": None, "max": 0}]],
     "flatdemandstructure": [[{"rate": 2.0}]], "flatdemandmonths": []},
], ids=["blank", "null_fixed", "zero_demand", "null_rates"])
def test_blank_record_degrades_to_inert_flat(record):
    got = urdb.urdb_rate_to_specs(record)
    _same(got, jurdb.urdb_rate_to_specs(record))
    normalize_tariff_spec(got[0])
    if record == {"label": "empty"}:
        assert got[0]["price"] == [[0.1]] and got[1] is None


def test_download_paginates_with_injected_fetch():
    pages = {0: [{"label": i} for i in range(3)], 3: [{"label": 3}]}

    def pull(mod):
        urls = []

        def fetch(url):
            urls.append(url)
            offset = int(url.split("offset=")[1].split("&")[0])
            return json.dumps({"items": pages.get(offset, [])}).encode()

        recs = mod.download_tariffs_from_urdb("KEY", sector="Residential",
                                              utility="Util", limit=3, fetch=fetch)
        return recs, urls

    got, want = pull(urdb), pull(jurdb)
    assert got == want
    assert [r["label"] for r in got[0]] == [0, 1, 2, 3]
    assert len(got[1]) == 2 and got[1][0].startswith(urdb.URDB_API_URL)
    assert urdb.URDB_API_URL == jurdb.URDB_API_URL


def _portfolio():
    rng = np.random.default_rng(0)
    n = 24
    base = rng.uniform(0.5, 2.0, (n, 1))
    shape = 1.0 + 0.5 * np.sin(np.arange(8760) * 2 * np.pi / 24)[None, :]
    return n, base * shape, rng.uniform(10, 200, n)


DESIGN = dict(avg_rev=0.15, peak_hour_indices=range(14, 20),
              summer_month_indices=[5, 6, 7, 8], rev_f_d=[0.4875, 0.5, 0.5],
              rev_f_e=[0.4875, 0.20, 0.80], rev_f_fixed=[0.025])


def test_design_tariff_extracts_target_revenue():
    n, loads, weights = _portfolio()
    out = urdb.design_tariff_for_portfolio(loads, weights, **DESIGN)
    _same(out, jurdb.design_tariff_for_portfolio(loads, weights, **DESIGN))
    chk = out["revenue_check"]
    assert chk["achieved_usd"] == pytest.approx(chk["target_usd"], rel=1e-9)
    assert chk["avg_rev_per_kwh"] == pytest.approx(0.15, rel=1e-9)
    assert out["charges"]["e_peak"] > out["charges"]["e_offpeak"] > 0
    with pytest.raises(ValueError, match="8760"):
        urdb.design_tariff_for_portfolio(loads[:, :100], weights, **DESIGN)

    # the port's bill engine collects the designed energy and fixed revenue
    from dgen_tpu_torch.ops import bill as bill_ops
    from dgen_tpu_torch.ops.tariff import compile_tariffs, expand_schedule_8760

    bank = compile_tariffs([out["energy_spec"]], device="cpu")
    take = list(range(0, n, 6))
    at = bill_ops.gather_tariff(bank, torch.zeros(len(take), dtype=torch.int32))
    period = expand_schedule_8760(np.asarray(out["energy_spec"]["e_wkday_12by24"]),
                                  np.asarray(out["energy_spec"]["e_wkend_12by24"]))
    bills = bill_ops.annual_bill(
        torch.from_numpy(loads[take].astype(np.float32)), at,
        torch.zeros((len(take), 8760)), bank.max_periods).numpy()
    expect = np.array([
        out["charges"]["e_peak"] * float(loads[i][period == 1].sum())
        + out["charges"]["e_offpeak"] * float(loads[i][period == 0].sum())
        + out["charges"]["fixed_monthly"] * 12.0
        for i in take
    ])
    np.testing.assert_allclose(bills, expect, rtol=1e-4)


def test_schedule_remap_never_mutates_caller_arrays():
    sched = np.full((12, 24), 7, np.int64)
    months = np.asarray([5] * 12, np.int64)
    record = {
        "energyratestructure": [[{"rate": 0.1}], [{"rate": 0.2}]],
        "energyweekdayschedule": sched,
        "energyweekendschedule": sched,
        "flatdemandstructure": [[{"rate": 3.0}], [{"rate": 5.0}]],
        "flatdemandmonths": months,
    }
    energy, demand = urdb.urdb_rate_to_specs(record)
    _same((energy, demand), jurdb.urdb_rate_to_specs(record))
    assert np.all(np.asarray(energy["e_wkday_12by24"]) == 0)
    np.testing.assert_array_equal(sched, np.full((12, 24), 7, np.int64))
    np.testing.assert_array_equal(months, np.asarray([5] * 12, np.int64))
