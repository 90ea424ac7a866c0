"""Golden-vector store: the reference's committed stores, checked and
regenerated through the port.

The reference commits the f32 bit patterns of its division-mode cells as
``.npz`` stores (``src/repro/eval/golden/``). This module reads them as data,
pushes the stored inputs through the port's modes on a chosen device, and
diffs in integer ULPs (default tolerance 0):

    PYTHONPATH=src python -m repro_torch.eval.golden --device cpu
    PYTHONPATH=src python -m repro_torch.eval.golden --generate --out build/golden --device cpu

The cell lists and the operand corpora are the reference's
(``golden_cells`` ... ``golden_softmax_inputs``: the same numpy draws, the
same arrays bit for bit). ``generate*`` write the port's own stores, in the
reference's layout, to a directory of the caller's (``build/golden`` by
default, which git ignores): the committed stores are never written. Every
cell of the reciprocal, divide and rsqrt stores is checked at 0 int ulp,
the ILM cell included; the softmax store is checked by :func:`check_softmax`
within ``SOFTMAX_TOLERANCE_ULP`` (its sums run in another order, F5, and
its exp is torch's, F3; the reference itself drifts from that store, F1).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ulp

__all__ = ["GOLDEN_DIR", "GOLDEN_PATH", "DIVIDE_PATH", "RSQRT_PATH", "SOFTMAX_PATH",
           "OUT_DIR", "SOFTMAX_TOLERANCE_ULP", "golden_cells", "golden_div_cells",
           "golden_rsqrt_cells", "golden_softmax_cells", "golden_inputs",
           "golden_numerators", "golden_div_inputs", "golden_rsqrt_inputs",
           "golden_softmax_inputs", "generate", "generate_divide", "generate_rsqrt",
           "generate_softmax", "check", "check_divide", "check_rsqrt", "check_softmax",
           "softmax_drift"]

GOLDEN_DIR = Path(__file__).resolve().parents[2] / "repro" / "eval" / "golden"
GOLDEN_PATH = GOLDEN_DIR / "reciprocal_v1.npz"
DIVIDE_PATH = GOLDEN_DIR / "divide_v1.npz"
RSQRT_PATH = GOLDEN_DIR / "rsqrt_v1.npz"
SOFTMAX_PATH = GOLDEN_DIR / "softmax_v1.npz"
# Where the generators write by default (relative to the working directory;
# build/ is listed in .gitignore).
OUT_DIR = Path("build") / "golden"
# The port's softmax against the reference's on oracle-normal lanes
# (tests/test_torch_consumers.py SOFTMAX_VS_REF_ULP, F5).
SOFTMAX_TOLERANCE_ULP = 16

def golden_cells() -> List[Tuple[str, Dict]]:
    """(key, DivisionConfig kwargs) of the reciprocal store."""
    return [
        ("recip/taylor/paper/n2p24",
         dict(mode="taylor", schedule="paper", n_iters=2, precision_bits=24)),
        ("recip/taylor/factored/n2p24",
         dict(mode="taylor", schedule="factored", n_iters=2, precision_bits=24)),
        ("recip/taylor/factored/n1p12",
         dict(mode="taylor", schedule="factored", n_iters=1, precision_bits=12)),
        ("recip/taylor_pallas/factored/n2p24",
         dict(mode="taylor_pallas", schedule="factored", n_iters=2,
              precision_bits=24)),
        ("recip/goldschmidt/n2p24",
         dict(mode="goldschmidt", n_iters=2, precision_bits=24)),
        ("recip/goldschmidt_pallas/n2p24",
         dict(mode="goldschmidt_pallas", n_iters=2, precision_bits=24)),
        ("recip/ilm/n2p24", dict(mode="ilm", n_iters=2, precision_bits=24)),
        ("div/goldschmidt/n2p24",
         dict(mode="goldschmidt", n_iters=2, precision_bits=24)),
    ]


def golden_div_cells() -> List[Tuple[str, Dict]]:
    """(key, DivisionConfig kwargs) of the divide store."""
    return [
        ("div/taylor/paper/n2p24",
         dict(mode="taylor", schedule="paper", n_iters=2, precision_bits=24)),
        ("div/taylor/factored/n2p24",
         dict(mode="taylor", schedule="factored", n_iters=2,
              precision_bits=24)),
        ("div/taylor/factored/n1p12",
         dict(mode="taylor", schedule="factored", n_iters=1,
              precision_bits=12)),
        ("div/taylor_pallas/factored/n2p24",
         dict(mode="taylor_pallas", schedule="factored", n_iters=2,
              precision_bits=24)),
        ("div/goldschmidt/n2p24",
         dict(mode="goldschmidt", n_iters=2, precision_bits=24)),
        ("div/goldschmidt_pallas/n2p24",
         dict(mode="goldschmidt_pallas", n_iters=2, precision_bits=24)),
    ]


def golden_rsqrt_cells() -> List[Tuple[str, Dict]]:
    """(key, DivisionConfig kwargs) of the rsqrt store."""
    return [
        ("rsqrt/taylor/newton2", dict(mode="taylor")),
        ("rsqrt/taylor/newton3", dict(mode="taylor", rsqrt_newton=3)),
        ("rsqrt/goldschmidt/newton2", dict(mode="goldschmidt")),
        ("rsqrt/taylor/newton2/ftz", dict(mode="taylor", underflow="ftz")),
    ]


def golden_softmax_cells() -> List[Tuple[str, Dict]]:
    """(key, DivisionConfig kwargs) of the softmax store."""
    return [
        ("softmax/taylor/paper/n2p24",
         dict(mode="taylor", schedule="paper", n_iters=2, precision_bits=24)),
        ("softmax/taylor/factored/n2p24",
         dict(mode="taylor", schedule="factored", n_iters=2,
              precision_bits=24)),
        ("softmax/taylor_pallas/factored/n2p24",
         dict(mode="taylor_pallas", schedule="factored", n_iters=2,
              precision_bits=24)),
        ("softmax/goldschmidt/n2p24",
         dict(mode="goldschmidt", n_iters=2, precision_bits=24)),
        ("softmax/goldschmidt_pallas/n2p24",
         dict(mode="goldschmidt_pallas", n_iters=2, precision_bits=24)),
        ("softmax/ilm/n2p24", dict(mode="ilm", n_iters=2, precision_bits=24)),
    ]


def golden_inputs() -> np.ndarray:
    """The reciprocal corpus: logspace, mantissa-dense, IEEE edges,
    subnormals (515 f32 values)."""
    parts = [
        ulp.sweep_logspace(256, "float32", seed=101),
        ulp.sweep_mantissa(96, "float32", seed=102),
        ulp.sweep_edges("float32"),
        ulp.sweep_subnormals(32, "float32", seed=103),
    ]
    return np.concatenate(parts).astype(np.float32)


def golden_numerators(n: int) -> np.ndarray:
    """The numerators of the reciprocal store's div cell."""
    return ulp.sweep_logspace(n, "float32", seed=104)


def golden_div_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """The divide store's (a, b) pairs: logspace, ratio extremes, quotients
    at the under/overflow cliffs, the IEEE edge cross product, subnormal
    denominators."""
    b_log = ulp.sweep_logspace(192, "float32", seed=201)
    a_log = ulp.sweep_logspace(192, "float32", seed=202)
    a_rx, b_rx = ulp.sweep_ratio_extremes(128, "float32", seed=203)
    a_qe, b_qe = ulp.sweep_quotient_edges(96, "float32", seed=204)
    a_ed, b_ed = ulp.div_edge_pairs("float32")
    b_sub = ulp.sweep_subnormals(32, "float32", seed=205)
    a_sub = ulp.sweep_logspace(32, "float32", seed=206)
    a = np.concatenate([a_log, a_rx, a_qe, a_ed, a_sub]).astype(np.float32)
    b = np.concatenate([b_log, b_rx, b_qe, b_ed, b_sub]).astype(np.float32)
    return a, b


def golden_rsqrt_inputs() -> np.ndarray:
    """The rsqrt corpus: positive logspace over both exponent parities,
    mantissa-dense [1, 4), IEEE edges, subnormal operands."""
    parts = [
        np.abs(ulp.sweep_logspace(256, "float32", seed=301)),
        ulp.sweep_exponent_parity(128, "float32", seed=302),
        ulp.sweep_rsqrt_mantissa(96, "float32", seed=303),
        ulp.sweep_edges("float32"),
        np.abs(ulp.sweep_subnormals(32, "float32", seed=304)),
    ]
    return np.concatenate(parts).astype(np.float32)


def golden_softmax_inputs() -> np.ndarray:
    """The softmax store's (123, 64) logit rows: the consumer strata and the
    edge rows (fully masked, single survivor, nan)."""
    from . import consumers

    strata = consumers.softmax_rows("float32", n_rows=24, d=64, seed=401)
    parts = [strata[k] for k in sorted(strata)]
    parts.append(consumers.softmax_edge_rows("float32", d=64))
    return np.concatenate(parts).astype(np.float32)


def compute(key: str, kw: Dict, x: np.ndarray, a: np.ndarray,
            device="cuda") -> np.ndarray:
    """One cell's f32 output on ``device``: div(a, x), rsqrt(x), softmax(x)
    over the last axis or recip(x)."""
    from repro_torch.core.division_modes import DivisionConfig, div, recip, rsqrt, softmax

    cfg = DivisionConfig(**kw)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if key.startswith("div/"):
        out = div(torch.from_numpy(np.ascontiguousarray(a)).to(device), xt, cfg)
    elif key.startswith("rsqrt/"):
        out = rsqrt(xt, cfg)
    elif key.startswith("softmax/"):
        out = softmax(xt, -1, cfg)
    else:
        out = recip(xt, cfg)
    return out.cpu().numpy().astype(np.float32)


def _diff(cells, stored, x, a, tolerance_ulp, device, locate) -> List[Dict]:
    failures: List[Dict] = []
    for key, kw in cells:
        if key not in stored:
            failures.append({"cell": key, "error": "missing from store"})
            continue
        want = stored[key].view(np.float32)
        d = ulp.ulp_diff(compute(key, kw, x, a, device), want)
        bad = d > tolerance_ulp
        if bad.any():
            failures.append({"cell": key, "n_mismatch": int(bad.sum()),
                             "max_ulp_drift": int(d.max()),
                             "first": locate(int(np.argmax(d)))})
    return failures


def _load(path: Path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def check(path: Path = GOLDEN_PATH, tolerance_ulp: int = 0,
          device="cuda") -> List[Dict]:
    """Diff the reciprocal store (and its div cell). Empty list = pass."""
    z = _load(path)
    stored = {k[len("out:"):]: v for k, v in z.items() if k.startswith("out:")}
    return _diff(golden_cells(), stored, z["inputs"], z["numerators"],
                 tolerance_ulp, device, lambda i: float(z["inputs"][i]))


def check_divide(path: Path = DIVIDE_PATH, tolerance_ulp: int = 0,
                 device="cuda") -> List[Dict]:
    """Diff the divide store. Empty list = pass."""
    z = _load(path)
    stored = {k[len("out:"):]: v for k, v in z.items() if k.startswith("out:")}
    return _diff(golden_div_cells(), stored, z["b"], z["a"], tolerance_ulp,
                 device, lambda i: (float(z["a"][i]), float(z["b"][i])))


def check_rsqrt(path: Path = RSQRT_PATH, tolerance_ulp: int = 0,
                device="cuda") -> List[Dict]:
    """Diff the rsqrt store. Empty list = pass."""
    z = _load(path)
    stored = {k[len("out:"):]: v for k, v in z.items() if k.startswith("out:")}
    return _diff(golden_rsqrt_cells(), stored, z["inputs"], z["inputs"],
                 tolerance_ulp, device, lambda i: float(z["inputs"][i]))


def _write(path, arrays: Dict[str, np.ndarray], cells, x, a, device) -> Path:
    """Every cell's output bits beside the inputs, in the reference's layout
    (``out:<cell>`` as uint32, a JSON ``meta``)."""
    for key, kw in cells:
        arrays["out:" + key] = compute(key, kw, x, a, device).view(np.uint32)
    arrays["meta"] = np.frombuffer(json.dumps({
        "version": 1, "torch": torch.__version__, "numpy": np.__version__,
        "device": str(device)}).encode(), np.uint8)
    path = Path(path)
    if path.resolve().parent == GOLDEN_DIR:
        raise ValueError(f"{path}: the committed stores are the reference's; write the "
                         "port's elsewhere")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def generate(path=OUT_DIR / GOLDEN_PATH.name, device="cuda") -> Path:
    """The reciprocal store (and its div cell) through the port on ``device``."""
    x = golden_inputs()
    a = golden_numerators(x.size)
    return _write(path, {"inputs": x, "numerators": a}, golden_cells(), x, a, device)


def generate_divide(path=OUT_DIR / DIVIDE_PATH.name, device="cuda") -> Path:
    """The divide store through the port on ``device``."""
    a, b = golden_div_inputs()
    return _write(path, {"a": a, "b": b}, golden_div_cells(), b, a, device)


def generate_rsqrt(path=OUT_DIR / RSQRT_PATH.name, device="cuda") -> Path:
    """The rsqrt store through the port on ``device``."""
    x = golden_rsqrt_inputs()
    return _write(path, {"inputs": x}, golden_rsqrt_cells(), x, x, device)


def generate_softmax(path=OUT_DIR / SOFTMAX_PATH.name, device="cuda") -> Path:
    """The softmax store through the port on ``device`` (its bits are not
    the committed store's: :func:`check_softmax`)."""
    x = golden_softmax_inputs()
    return _write(path, {"inputs": x}, golden_softmax_cells(), x, x, device)


def softmax_drift(path: Path = SOFTMAX_PATH, device="cuda") -> Dict[str, Dict]:
    """Per softmax cell: the largest int-ulp distance from the store on the
    lanes whose f64 softmax is a normal f32 (``max_ulp``), the number of
    those lanes that differ (``lanes``) and the worst one (``worst``, row
    and column). Below the normal range XLA on the CPU flushes (F4) and the
    port keeps the subnormal, so those lanes are the edge class, not an ulp
    statistic (as ``tests/test_torch_consumers.py`` holds them)."""
    from . import consumers

    z = _load(path)
    x = z["inputs"]
    normal = ulp.oracle_mask(consumers.softmax_oracle(x.astype(np.float64)), "float32")
    out = {}
    for key, kw in golden_softmax_cells():
        d = np.where(normal, ulp.ulp_diff(compute(key, kw, x, x, device),
                                          z["out:" + key].view(np.float32)), 0)
        out[key] = {"max_ulp": int(d.max()), "lanes": int((d > 0).sum()),
                    "worst": tuple(int(j) for j in np.unravel_index(int(np.argmax(d)),
                                                                    d.shape))}
    return out


def check_softmax(path: Path = SOFTMAX_PATH, tolerance_ulp: int = SOFTMAX_TOLERANCE_ULP,
                  device="cuda") -> List[Dict]:
    """Diff the softmax store in int ulps on its oracle-normal lanes
    (:func:`softmax_drift`). Empty list = pass."""
    return [{"cell": key, "n_mismatch": d["lanes"], "max_ulp_drift": d["max_ulp"],
             "first": d["worst"]}
            for key, d in softmax_drift(path, device).items() if d["max_ulp"] > tolerance_ulp]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tolerance-ulp", type=int, default=0)
    ap.add_argument("--generate", action="store_true",
                    help="write the port's four stores to --out instead of checking")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of --generate (never the committed stores')")
    args = ap.parse_args(argv)
    if args.generate:
        out = Path(args.out)
        for fn, ref in ((generate, GOLDEN_PATH), (generate_divide, DIVIDE_PATH),
                        (generate_rsqrt, RSQRT_PATH), (generate_softmax, SOFTMAX_PATH)):
            p = fn(out / ref.name, device=args.device)
            print(f"wrote {p} ({p.stat().st_size} bytes)")
        return 0
    failures = (check(tolerance_ulp=args.tolerance_ulp, device=args.device)
                + check_divide(tolerance_ulp=args.tolerance_ulp, device=args.device)
                + check_rsqrt(tolerance_ulp=args.tolerance_ulp, device=args.device)
                + check_softmax(device=args.device))
    for f in failures:
        print(f"  {f}")
    if failures:
        print("GOLDEN-VECTOR REGRESSION")
        return 1
    print("golden vectors ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
