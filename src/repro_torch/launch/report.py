"""Render the roofline table from the dry run's JSON files.

The port of ``src/repro/launch/report.py``: one row per cell of a mesh and
variant (its roofline terms, bound, step time, MFU, the FLOP efficiency, the
memory a device holds and whether it fits the H100's 80 GB, and the NVLink
and inter-host wire bytes under the reference's ICI / DCN headings), the
collectives of each cell by mesh axis (the tensor-parallel all-reduces on
``model``, the gradients' mean on the data axes), then the sharding
fallbacks.

  PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun --variant tp1
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import HBM_BYTES

HBM_CAP = HBM_BYTES  # one H100 SXM (launch/roofline.py)


def load_cells(d: str):
    cells = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_bytes(b):
    b = max(0.0, b)
    if b >= 1e9:
        return f"{b/1e9:.1f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def table(cells, mesh="single", variant="base"):
    rows = [c for c in cells if c["mesh"] == mesh and c.get("variant", "base") == variant]
    rows.sort(key=lambda c: (c["arch"], c["shape"]))
    out = []
    out.append("| arch | shape | t_compute | t_memory | t_collective | bound "
               "| t_step | MFU | flops_eff | HBM/dev | fits | ICI | DCN |")
    out.append("|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for c in rows:
        r = c["roofline"]
        mem = c["memory"]["total_hbm_bytes"]
        fits = "yes" if mem <= HBM_CAP else "**NO**"
        out.append(
            f"| {c['arch']} | {c['shape']} | {r['t_compute']*1e3:.1f}ms "
            f"| {r['t_memory']*1e3:.1f}ms | {r['t_collective']*1e3:.1f}ms "
            f"| **{r['bound']}** | {r['t_step']*1e3:.1f}ms "
            f"| {r['mfu']:.3f} | {r['flops_efficiency']:.2f} "
            f"| {fmt_bytes(mem)} | {fits} | {fmt_bytes(r['ici_bytes'])} "
            f"| {fmt_bytes(r['dcn_bytes'])} |")
    return "\n".join(out)


def collectives_section(cells, mesh="single", variant="base"):
    """Per-cell table of the collectives the traced rank issued, by mesh
    axis and op: count and wire bytes."""
    rows = [c for c in cells
            if c["mesh"] == mesh and c.get("variant", "base") == variant
            and c["collectives"].get("by_axis")]
    if not rows:
        return ""
    rows.sort(key=lambda c: (c["arch"], c["shape"]))
    out = ["", "### Collectives by mesh axis", "",
           "| arch | shape | axis | op | count | wire bytes |", "|---|---|---|---|---|---|"]
    for c in rows:
        for ax, ops in sorted(c["collectives"]["by_axis"].items()):
            for op, a in sorted(ops.items()):
                out.append(f"| {c['arch']} | {c['shape']} | {ax} | {op} | {a['count']} "
                           f"| {fmt_bytes(a['wire_bytes'])} |")
    return "\n".join(out)


def fallbacks_section(cells, mesh="single", variant="base"):
    """Per-cell table of silent sharding drops (rules.param_fallbacks):
    every (param, dim) whose rule named a mesh axis that was dropped, with
    the full replicated byte size. Empty when every rule resolved."""
    rows = [c for c in cells
            if c["mesh"] == mesh and c.get("variant", "base") == variant
            and c.get("sharding_fallbacks")]
    if not rows:
        return ""
    seen = set()
    out = ["", "### Sharding fallbacks (replicated despite a rule)", "",
           "| arch | param | shape | axis -> mesh axis | reason | bytes |",
           "|---|---|---|---|---|---|"]
    for c in rows:
        for fb in c["sharding_fallbacks"]:
            key = (c["arch"], fb["param"], fb["dim"])
            if key in seen:     # one line per param/dim, not per shape cell
                continue
            seen.add(key)
            out.append(
                f"| {c['arch']} | {fb['param']} | "
                f"{'x'.join(str(s) for s in fb['shape'])} "
                f"| {fb['logical_axis']} -> {fb['mesh_axis']} "
                f"(dim {fb['dim']}: {fb['dim_size']} % "
                f"{fb['mesh_axis_size']}) | {fb['reason']} "
                f"| {fmt_bytes(fb['bytes'])} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="base")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    print(table(cells, args.mesh, args.variant))
    for section in (collectives_section, fallbacks_section):
        text = section(cells, args.mesh, args.variant)
        if text:
            print(text)


if __name__ == "__main__":
    main()
