"""Shared by the two conformance parity files: both runners over one set of
cells, and what a port cell must show against the reference's cell.

Bit-identical datapaths (taylor, taylor_pallas, goldschmidt,
goldschmidt_pallas, ilm for recip, div and rsqrt) give the reference's
statistics exactly: every stratum's max, mean, p99 and lane count, and its
edge failures. The other cells are held within these tolerances, each for
its reason:

  * ``exact`` recip/div/rsqrt: max ulp within ``EXACT_MAX_ULP_TOL`` of the
    reference's. torch keeps subnormals (F4), so the port's exact cells are
    gradual and measure subnormal lanes the reference's FTZ cells leave out,
    and torch's CPU rsqrt is not correctly rounded (1.28 max ulp measured
    against XLA's 0.87).
  * consumer cells: the gated vs-exact-twin integer ulp within 1 (or 0.1%
    for ILM) of the reference's, and the oracle max ulp within 4 (or 0.1%):
    exp differs by an ulp (F3) and the row sums run in another order (F5).

Every port cell also passes ``cell_gate``.
"""
import dataclasses

from repro.eval import conformance as ref_conformance
from repro_torch.eval import conformance

N = 256
SCALAR_OPS = ("recip", "div", "rsqrt")
BIT_IDENTICAL = ("taylor", "taylor_pallas", "goldschmidt", "goldschmidt_pallas", "ilm")
EXACT_MAX_ULP_TOL = 0.5


def grid_keys(ops):
    return [c.key for c in conformance.default_grid(quick=True) if c.op in ops]


def reports(ops):
    """({key: port cell}, {key: reference cell}) over the quick grid's cells
    of ``ops``."""
    cells = [c for c in conformance.default_grid(quick=True) if c.op in ops]
    port = conformance.run_conformance(cells, n_log=N, n_man=N, quick=True, device="cpu")
    ref = ref_conformance.run_conformance(
        [ref_conformance.Cell(**dataclasses.asdict(c)) for c in cells],
        n_log=N, n_man=N, quick=True)
    return ({c["key"]: c for c in port["cells"]}, {c["key"]: c for c in ref["cells"]})


def _near(got, want, abs_tol, rel=1e-3):
    return abs(got - want) <= max(abs_tol, rel * abs(want))


def check_cell(both, key):
    p, r = both[0][key], both[1][key]
    assert p["pass"] and conformance.cell_gate(p), p
    assert p["edge_failures"] == r["edge_failures"] == 0
    if p["op"] in SCALAR_OPS and p["mode"] in BIT_IDENTICAL:
        assert p["overall"] == r["overall"]
        assert p["strata"] == r["strata"]
    elif p["op"] in SCALAR_OPS:
        assert abs(p["overall"]["max_ulp"] - r["overall"]["max_ulp"]) <= EXACT_MAX_ULP_TOL
    else:
        assert _near(p["vs_exact_max_ulp"], r["vs_exact_max_ulp"], 1)
        assert _near(p["overall"]["max_ulp"], r["overall"]["max_ulp"], 4.0)
        if p["op"] == "softmax":
            assert _near(p["row_sum_max_ulp1"], r["row_sum_max_ulp1"], 1.0)
