"""Render the dry run's records (results/dryrun/) as tables, as the JAX
package's ``launch/report.py`` renders its own.

    PYTHONPATH=src python -m repro_torch.launch.report [--out results/roofline.md]

Times are the roofline's terms against one NVIDIA H100 80GB HBM3's
data-sheet rates; sizes are shape counts (GB = 1e9 bytes), not
measurements. An ``lm`` cell's resident GB are its blocks and its peak
``analytic_cell``'s; a ``layout`` or ``pp`` record's resident GB are its
step's argument bytes and its peak the counted one (``launch/opcount.py``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_all(root="results/dryrun"):
    recs = []
    for f in sorted(glob.glob(os.path.join(root, "*", "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    return f"{b / 1e9:.1f}"


def _flags(rec):
    o = rec.get("opts", {})
    out = []
    if o.get("seq_shard"):
        out.append("SP")
    if o.get("fsdp"):
        out.append("FSDP")
    if o.get("zero_opt"):
        out.append("Z1")
    if o.get("accum", 1) > 1:
        out.append(f"acc{o['accum']}")
    if o.get("remat") not in (None, "none"):
        out.append("rm")
    return "+".join(out) or "-"


def roofline_table(recs, mesh: str) -> str:
    rows = [r for r in recs if r["mesh"] == mesh and "roofline" in r]
    rows.sort(key=lambda r: (r["arch"], r["cell"]))
    out = ["| arch | cell | flags | compute s | memory s | collective s | "
           "bound | MODEL_FLOPs/counted | roofline frac | resident GB | "
           "peak GB | fits |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        t = r["roofline"]
        mem = r.get("memory", {})
        resident = mem.get("resident_bytes", {}).get(
            "total", mem.get("argument_bytes", 0))
        peak = mem.get("peak_bytes_analytic", mem.get("peak_bytes", 0))
        out.append(
            f"| {r['arch']} | {r['cell']} | {_flags(r)} "
            f"| {t['compute_s']:.3f} | {t['memory_s']:.3f} "
            f"| {t['collective_s']:.3f} | {t['bottleneck']} "
            f"| {t.get('useful_ratio', 0):.2f} | {t['roofline_frac']:.3f} "
            f"| {fmt_bytes(resident)} | {fmt_bytes(peak)} "
            f"| {'Y' if mem.get('fits_hbm') else 'N'} |")
    return "\n".join(out)


def dryrun_summary(recs) -> str:
    out = ["| arch | cell | mesh | step s | counted flops/dev | "
           "coll GB/dev | top collective |", "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["cell"], r["mesh"])):
        t = r.get("roofline", {})
        cols = r.get("collectives", [])
        top = (f"{cols[0]['op']}(g={cols[0]['group']}) "
               f"{cols[0]['bytes'] / 1e9:.1f}GB" if cols else "-")
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} "
            f"| {r.get('step_s', 0):.0f} | {t.get('flops', 0):.2e} "
            f"| {t.get('coll_bytes', 0) / 1e9:.1f} | {top} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="results/dryrun")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args(argv)
    recs = load_all(args.root)
    parts = ["## Roofline — 16×16 (256 cards)\n",
             roofline_table(recs, "16x16"),
             "\n\n## Roofline — 2×16×16 (512 cards)\n",
             roofline_table(recs, "2x16x16"),
             "\n\n## Dry-run detail\n", dryrun_summary(recs)]
    txt = "\n".join(parts)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(txt)
    print(f"wrote {args.out} ({len(recs)} cells)")
    return txt


if __name__ == "__main__":
    main()
