"""Quickstart through the PyTorch port: the paper's division unit, on the card.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the seed
segments, the Taylor reciprocal's precision dial, the ILM's accuracy dial,
the powering unit and softmax through the unit. ``--device cuda`` (the
default) runs the kernel modes on the Hopper kernels; ``--device cpu`` on
their plain PyTorch versions.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ilm, powering, seeds
from repro_torch.core.division_modes import DivisionConfig, recip, softmax


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print("=" * 72)
    print("1. Piecewise-linear seed segments (paper §3, Table I)")
    table = seeds.compute_segments(n_iters=5, precision_bits=53)
    print(f"   segments for n=5 @ 53 bits: {np.round(table.boundaries[1:], 5)}")
    print(f"   paper Table I:              {seeds.PAPER_TABLE_I}")
    print(f"   single linear seed on [1,2] would need "
          f"{seeds.iterations_required(1, 2, 53)} iterations (paper: 17)")

    print("=" * 72)
    print(f"2. Taylor-series reciprocal (paper §2) on {dev} — precision is a dial")
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 100, 10_000)
                         .astype(np.float32)).to(dev)
    for mode, n, prec in [("taylor", 1, 12), ("taylor", 2, 24), ("taylor_pallas", 2, 24)]:
        cfg = DivisionConfig(mode=mode, n_iters=n, precision_bits=prec)
        err = float(torch.max(torch.abs(recip(x, cfg) * x - 1)))
        print(f"   {mode:13s} n={n} ({prec}-bit table): max rel err of reciprocal = {err:.2e}")

    print("=" * 72)
    print("3. Iterative Logarithmic Multiplier (paper §4) — accuracy dial")
    rng = np.random.default_rng(1)
    a = rng.integers(1, 2**16, 20_000).astype(np.uint64)
    b = rng.integers(1, 2**16, 20_000).astype(np.uint64)
    for iters in (1, 2, 4, 16):
        p = ilm.ilm_mul_np(a, b, iters)
        rel = float(np.max((a * b - p) / (a * b)))
        print(f"   {iters:2d} iteration(s): worst product error = {rel:.4%}")

    print("=" * 72)
    print("4. Powering unit (paper §6): odd by multiply, even by square")
    print(f"   schedule for x^2..x^5: {powering.schedule(5)}")
    hw = powering.hw_cost()
    print(f"   squaring unit area ratio vs multiplier: {hw['area_ratio']:.1%}"
          f"  (<50% as claimed in §5)")

    print("=" * 72)
    print("5. Where it lands in an LLM: softmax through the division unit")
    logits = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32) * 3).to(dev)
    s_exact = softmax(logits, -1, DivisionConfig(mode="exact"))
    s_tsdiv = softmax(logits, -1, DivisionConfig(mode="taylor_pallas"))
    print(f"   max |softmax_taylor_pallas - softmax_exact| = "
          f"{float(torch.max(torch.abs(s_tsdiv - s_exact))):.2e}")
    print("done.")


if __name__ == "__main__":
    main()
