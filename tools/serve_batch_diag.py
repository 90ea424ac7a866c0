"""Does a served model give a request the same numbers alone and in a batch?

    python3 tools/serve_batch_diag.py [--device cpu --smoke] [--archs A,B] [--json PATH]

For gemma3_12b and deepseek_moe_16b at full width in bf16 (params from
``--seed``, capacity factor 8: no token is dropped), deepseek_moe_16b in
f32 at 4 layers, and mamba2_780m at full width in bf16 and in f32
(``--archs`` picks among them), prefills the 4 prompts of
``chip_smoke.py``'s model phases once as a right-padded batch and once each
alone, in taylor_pallas, and prints one JSON line per model:

  * per request: whether the last logits' argmax agrees, their largest
    difference relative to the largest logit, and the batch run's top-2
    margin on the same scale (a difference above the margin can flip the
    greedy token);
  * for the shortest request, after each of the first 6 blocks: the share
    of its hidden-state elements that are bit-identical alone and in the
    batch, and their largest relative difference.

``serve()`` prefills each request alone and decodes a batch of 2 slots,
``generate_batch`` prefills and decodes the 4 together, so this is what sets
how far the two can agree. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LENS = (2048, 1536, 1024, 512)
LAYERS = 6


def _padded(prompts, align, device):
    n = -(-max(len(p) for p in prompts) // align) * align
    toks = torch.zeros((len(prompts), n), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    return toks.to(device), torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                         device=device)


def _hidden(cfg, params, toks, n_layers):
    """The residual stream after each of the first ``n_layers`` blocks."""
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.model import block_forward

    x = embed_tokens(params["embed"], toks, cfg)
    b, s = toks.shape
    pos = torch.arange(s, dtype=torch.int32, device=toks.device).expand(b, s)
    layers = [lp for g in params["groups"] for lp in g["layers"]]
    out = []
    for lp, spec in list(zip(layers, cfg.layer_specs()))[:n_layers]:
        x, _, _ = block_forward(lp, x, spec, cfg, pos, mode="train")
        out.append(x)
    return out


def diagnose(arch, dtype, seed, device, smoke, **repl):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine

    base = (get_smoke_config if smoke else get_config)(arch)
    cfg = dataclasses.replace(base, param_dtype=dtype, capacity_factor=8.0, **repl)
    cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division,
                                                                mode="taylor_pallas"))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    lens = tuple(max(2, n // 64) for n in LENS) if smoke else LENS
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    eng = ServingEngine(cfg, params, max_len=max(lens) + 1)
    toks, lengths = _padded(prompts, eng._align, device)
    batch_logits, _ = eng._prefill_tok(toks, lengths)
    rows = []
    for i, p in enumerate(prompts):
        t1, l1 = _padded([p], eng._align, device)
        alone, _ = eng._prefill_tok(t1, l1)
        scale = float(batch_logits[i].abs().max())
        top2 = torch.topk(batch_logits[i], 2).values
        rows.append({"tokens": len(p),
                     "same_argmax": bool(alone[0].argmax() == batch_logits[i].argmax()),
                     "rel_diff": float((alone[0] - batch_logits[i]).abs().max()) / scale,
                     "top2_margin_rel": float(top2[0] - top2[1]) / scale})
    i, n = len(prompts) - 1, len(prompts[-1])
    t1, _ = _padded([prompts[i]], eng._align, device)
    depth = min(LAYERS, cfg.n_layers)
    hb = _hidden(cfg, params, toks, depth)
    ha = _hidden(cfg, params, t1, depth)
    same = [float((b[i, :n] == a[0, :n]).float().mean()) for b, a in zip(hb, ha)]
    rel = [float((b[i, :n].float() - a[0, :n].float()).abs().max()
                 / a[0, :n].float().abs().max()) for b, a in zip(hb, ha)]
    return {"arch": arch, "dtype": dtype, "layers": cfg.n_layers, "capacity_factor": 8.0,
            "device": str(device), "last_logits": rows,
            "shortest_request_layers": [spec.ffn for spec in cfg.layer_specs()[:depth]],
            "bit_identical_share": same, "rel_diff": rel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs (a CPU check)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--archs", default="gemma3_12b,deepseek_moe_16b,mamba2_780m",
                    help="comma-separated models to diagnose")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        _build.build_all()
    results = []
    runs = (("gemma3_12b", "bfloat16", {}), ("deepseek_moe_16b", "bfloat16", {}),
            ("deepseek_moe_16b", "float32", {"n_layers": 4}),
            ("mamba2_780m", "bfloat16", {}), ("mamba2_780m", "float32", {}))
    for arch, dtype, repl in runs:
        if arch not in args.archs.split(","):
            continue
        results.append(diagnose(arch, dtype, args.seed, device, args.smoke, **repl))
        print(json.dumps(results[-1]), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
