"""chip_smoke.py's library yardstick computes each bucket-sums row's
function: one bmm of the pre-formed relu(net) (and net) with the one-hot
M that ``bmm_operands`` forms from a row's operands gives the row's plain
outputs, on full-hour and compacted lanes, with periods outside [0, P)
counted for the sell sum alone, for one tariff and two, at 12 P + 1
columns and wider."""

import importlib.util
import os

import pytest
import torch

from dgen_tpu_torch.ops import billkernels as bk
from dgen_tpu_torch.ops import layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()

#: compacted months of 128-lane multiples
COMPACTED = layout.seg_offsets([384, 256, 384, 512, 512, 512, 512, 512, 384, 384,
                                256, 256])


def _operands(form, p, offsets, seed):
    g = torch.Generator().manual_seed(seed)
    n, r, lanes = 3, 5, offsets[-1]

    def rand(scale):
        return torch.rand((n, lanes), generator=g, dtype=torch.float64).float() * scale

    def periods():
        per = torch.randint(0, p, (n, lanes), generator=g, dtype=torch.int32)
        per[0, 3], per[1, 7] = -1, p  # lanes that count for the sell sum alone
        return per

    load, gen, sell, sell_b = rand(3.0), rand(0.9), rand(0.1), rand(0.1)
    scales = torch.rand((n, r), generator=g) * 4.0
    if form.startswith("dot"):
        per = torch.randint(0, p, (n, lanes), generator=g, dtype=torch.int32)
        return ((load, gen, sell, bk.hourly_bucket_ids(per, p), scales, p,
                 form == "dot_signed"), bk.dot_sums_plain)
    if form == "pair":
        return ((load, gen, sell, periods(), sell_b, periods(), scales, offsets, p),
                bk.month_pair_sums_plain)
    return ((load, gen, sell, periods(), scales, offsets, p, form == "month_signed"),
            bk.month_sums_plain)


@pytest.mark.parametrize("p", [1, 2, 10])
@pytest.mark.parametrize("form,offsets", [
    ("month", layout.FULL_OFFSETS), ("month_signed", layout.FULL_OFFSETS),
    ("month_signed", COMPACTED), ("pair", layout.FULL_OFFSETS), ("pair", COMPACTED),
    ("dot", layout.FULL_OFFSETS), ("dot_signed", layout.FULL_OFFSETS),
], ids=lambda v: v if isinstance(v, str) else f"{v[-1]}lanes")
def test_bmm_yardstick_computes_the_rows_function(form, offsets, p):
    args, plain = _operands(form, p, offsets, seed=p)
    terms = cs.sums_terms(args)
    for cols in (12 * p + 1, 128):
        a, m = cs.bmm_operands(terms, 0, 3, cols)
        want = cs.bmm_outputs(torch.bmm(a.double(), m.double()), terms, cols)
        got = plain(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g.double(), w, rtol=1e-5, atol=1e-4)


def test_bmm_operands_cut_agent_rows():
    args, _ = _operands("pair", 2, layout.FULL_OFFSETS, seed=5)
    terms = cs.sums_terms(args)
    a, m = cs.bmm_operands(terms, 1, 3, 25)
    assert tuple(a.shape) == (2, 5, 8760) and tuple(m.shape) == (2, 8760, 50)
    whole_a, whole_m = cs.bmm_operands(terms, 0, 3, 25)
    assert torch.equal(a, whole_a[1:]) and torch.equal(m, whole_m[1:])
