"""Golden-vector check of the port against the reference's committed stores.

The reference commits the f32 bit patterns of its division-mode cells as
``.npz`` stores (``src/repro/eval/golden/``). This module reads them as data,
pushes the stored inputs through the port's modes on a chosen device, and
diffs in integer ULPs (default tolerance 0):

    PYTHONPATH=src python -m repro_torch.eval.golden --device cpu

The cell lists are the reference's (``golden_cells``, ``golden_div_cells``,
``golden_rsqrt_cells``); every cell of the three stores is checked, the ILM
cell included. The softmax store is not (F1).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ulp

__all__ = ["GOLDEN_DIR", "GOLDEN_PATH", "DIVIDE_PATH", "RSQRT_PATH",
           "golden_cells", "golden_div_cells", "golden_rsqrt_cells",
           "check", "check_divide", "check_rsqrt"]

GOLDEN_DIR = Path(__file__).resolve().parents[2] / "repro" / "eval" / "golden"
GOLDEN_PATH = GOLDEN_DIR / "reciprocal_v1.npz"
DIVIDE_PATH = GOLDEN_DIR / "divide_v1.npz"
RSQRT_PATH = GOLDEN_DIR / "rsqrt_v1.npz"

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


def compute(key: str, kw: Dict, x: np.ndarray, a: np.ndarray,
            device="cuda") -> np.ndarray:
    """One cell's f32 output on ``device``: div(a, x), rsqrt(x) or recip(x)."""
    from repro_torch.core.division_modes import DivisionConfig, div, recip, rsqrt

    cfg = DivisionConfig(**kw)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if key.startswith("div/"):
        out = div(torch.from_numpy(np.ascontiguousarray(a)).to(device), xt, cfg)
    elif key.startswith("rsqrt/"):
        out = rsqrt(xt, cfg)
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tolerance-ulp", type=int, default=0)
    args = ap.parse_args(argv)
    failures = (check(tolerance_ulp=args.tolerance_ulp, device=args.device)
                + check_divide(tolerance_ulp=args.tolerance_ulp, device=args.device)
                + check_rsqrt(tolerance_ulp=args.tolerance_ulp, device=args.device))
    for f in failures:
        print(f"  {f}")
    if failures:
        print("GOLDEN-VECTOR REGRESSION")
        return 1
    print("golden vectors ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
