"""Read the bf16 flash gate (``kernels.flash_attention.tc_gate``) on planted
faults: what it sees of a tensor-core kernel built wrongly.

    python3 tools/tc_gate_control.py [--device cpu|cuda]

Runs the tensor-core kernel's plain version (``flash_attention_tc_plain``)
as it is and with one fault planted, on the reference's bf16 cases and on
one head of the serving shape (2048, 64), causal, seeded q/k/v, and prints
one JSON line per case and fault with the gate's reading of the faulty
output against the sound one. The faults:

  * ``no_p_lo``: PV from one bf16 p (the p_lo step dropped), the design
    fault the p split exists to avoid; the gate must reject it
    (``tests/test_torch_flash_tc.py`` asserts so);
  * ``s_once_per_block``: each score rounded once after all of its head
    dims instead of once per 16 (one mma k-step); a change of rounding
    order of the kind the gate exists to tolerate.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CASES = [(2, 256, 64, 128, True), (3, 128, 32, 32, True), (2, 256, 64, 64, False),
         (1, 512, 128, 128, True), (2, 64, 16, 64, True), (1, 2048, 64, 128, True)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import flash_attention as fa, ops

    real_split, real_mma = fa.split_bf16, fa._mma_step
    for bh, s, hd, bk, causal in CASES:
        rng = np.random.default_rng(s + hd + 1)
        q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, hd)).astype(np.float32))
                   .to(args.device, torch.bfloat16) for _ in range(3))
        q3, k3, v3, kw = ops.flash_padded(q, k, v, block_k=bk)

        def run():
            return fa.flash_attention_tc_plain(q3, k3, v3, compute_segments(2, 24), 2,
                                               "factored", causal=causal,
                                               skip_masked_k=True, **kw)

        steps = {"n": 0}

        def s_once(acc, a, b):
            if acc.shape[-1] != -(-kw["block_k"] // fa.MMA_K) * fa.MMA_K or hd == fa.MMA_K:
                return real_mma(acc, a, b)          # a PV step (or one k-step per score)
            steps["n"] += 1
            out = acc.double() + a.double() @ b.double()
            return out.to(torch.float32) if steps["n"] % (hd // fa.MMA_K) == 0 else out

        sound = run()
        vmax = float(v.float().abs().max())
        for fault in ("no_p_lo", "s_once_per_block"):
            if fault == "no_p_lo":
                fa.split_bf16 = lambda p: (p.bfloat16().float(), torch.zeros_like(p))
            else:
                fa._mma_step = s_once
            try:
                bad = run()
            finally:
                fa.split_bf16, fa._mma_step = real_split, real_mma
            print(json.dumps({"case": [bh, s, hd, bk, causal], "fault": fault,
                              "gate": fa.tc_gate(bad, sound, vmax)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
