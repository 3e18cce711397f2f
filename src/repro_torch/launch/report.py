"""Fold results/dryrun_torch/*.json (:mod:`repro_torch.launch.dryrun`) into
roofline tables (``repro/launch/report.py``'s, with H100 figures: a rank
fits when its peak is within the card's 80 GB).

    PYTHONPATH=src python -m repro_torch.launch.report [--tag TAG] [--diff TAG2]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.roofline import HBM_BYTES

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")
ARCH_ORDER = [
    "whisper-medium", "minicpm3-4b", "granite-20b", "qwen3-8b", "internlm2-1.8b",
    "zamba2-1.2b", "arctic-480b", "qwen2-moe-a2.7b", "mamba2-130m", "pixtral-12b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(tag: str = "", results_dir: str = RESULTS_DIR) -> dict:
    recs = {}
    suffix = f"_{tag}" if tag else ""
    for f in glob.glob(os.path.join(results_dir, f"*{suffix}.json")):
        base = os.path.basename(f)[: -len(".json")]
        if tag:
            if not base.endswith(suffix):
                continue
            base = base[: -len(suffix)]
        elif base.count("__") != 2:
            continue
        arch, shape, pod = base.split("__")
        with open(f) as fh:
            recs[(arch, shape, pod)] = json.load(fh)
    return recs


def fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def fmt_ms(s):
    return f"{1e3 * s:.2f}" if s is not None else "-"


def roofline_table(recs, pod="pod1") -> list[str]:
    out = [
        "| arch | shape | fits? peak HBM/chip | compute ms | memory ms | collective ms | dominant | roofline frac | MODEL/HLO flops |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, pod))
            if r is None:
                continue
            if r.get("status") == "skipped":
                out.append(f"| {arch} | {shape} | skipped: {r['reason'][:40]}... | | | | | | |")
                continue
            if r.get("status") != "ok":
                out.append(f"| {arch} | {shape} | ERROR | | | | | | |")
                continue
            mem = r.get("memory", {})
            peak = mem.get("peak_hbm_bytes")
            fits = "Y" if (peak or 0) <= HBM_BYTES else "OVER"
            t = r.get("roofline", {})
            out.append(
                f"| {arch} | {shape} | {fits} {fmt_bytes(peak)} "
                f"| {fmt_ms(t.get('compute_s'))} | {fmt_ms(t.get('memory_s'))} "
                f"| {fmt_ms(t.get('collective_s'))} | {t.get('dominant','-')} "
                f"| {t.get('roofline_fraction', 0):.3f} "
                f"| {r.get('useful_flops_ratio', 0):.2f} |"
            )
    return out


def multipod_table(recs) -> list[str]:
    out = [
        "| arch | shape | pod2 compile | peak HBM/chip | collectives |",
        "|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, "pod2"))
            if r is None:
                continue
            if r.get("status") == "skipped":
                continue
            if r.get("status") != "ok":
                out.append(f"| {arch} | {shape} | ERROR | | |")
                continue
            mem = r.get("memory", {})
            coll = ", ".join(f"{k}x{v['count']}" for k, v in r.get("collectives", {}).items()) or "(in scan bodies)"
            out.append(
                f"| {arch} | {shape} | ok ({r.get('compile_s', 0):.0f}s) "
                f"| {fmt_bytes(mem.get('peak_hbm_bytes'))} | {coll} |"
            )
    return out


def _remat(r) -> str:
    """A train cell's ``remat`` (the mode its step ran with), for a table."""
    return f", remat {r['remat']}" if r.get("remat") and r.get("shape", "").startswith("train") else ""


def cells_table(recs, pod="pod1") -> list[str]:
    """One row a config, one column a shape: each cell's dominant roofline
    term, its bound and the rank's peak (decimal GB), as ``PERF.md`` §5
    tabulates a sweep; a train cell also names its ``remat``."""
    out = ["| Config | " + " | ".join(SHAPE_ORDER) + " |",
           "| --- |" + " --- |" * len(SHAPE_ORDER)]
    for arch in ARCH_ORDER:
        row = []
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, pod))
            if r is None:
                row.append("-")
            elif r.get("status") == "skipped":
                row.append("skipped")
            elif r.get("status") != "ok":
                row.append("raised")
            else:
                t = r["roofline"]
                row.append(f"{t['dominant']} {t['bound_s']:.4g} s, "
                           f"{r['memory']['peak_hbm_bytes'] / 1e9:.1f} GB{_remat(r)}")
        out.append(f"| {arch} | " + " | ".join(row) + " |")
    return out


def flops_table(recs) -> list[str]:
    """Each traced cell's useful FLOPs ratio (model FLOPs per rank over the
    rank's counted FLOPs) and the share of its counted FLOPs that a mesh
    axis could not split (``whole_flops_share``: heads that 'model' does not
    divide, computed whole on every rank of it), on both meshes."""
    out = ["| arch | shape | useful pod1 | whole pod1 | useful pod2 | whole pod2 |",
           "|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            cells = [recs.get((arch, shape, pod)) or {} for pod in ("pod1", "pod2")]
            if not any(r.get("status") == "ok" for r in cells):
                continue
            vals = []
            for r in cells:
                ok = r.get("status") == "ok"
                vals += [f"{r['useful_flops_ratio']:.3f}" if ok else "-",
                         f"{r.get('whole_flops_share', 0.0):.3f}" if ok else "-"]
            out.append(f"| {arch} | {shape}{_remat(cells[0] or cells[1])} | "
                       + " | ".join(vals) + " |")
    return out


def diff_table(base: dict, new: dict, cells: list[tuple[str, str]]) -> list[str]:
    out = [
        "| cell | term | before | after | delta |",
        "|---|---|---|---|---|",
    ]
    for arch, shape in cells:
        b = base.get((arch, shape, "pod1"), {})
        n = new.get((arch, shape, "pod1"), {})
        for term in ("compute_s", "memory_s", "collective_s"):
            tb = b.get("roofline", {}).get(term)
            tn = n.get("roofline", {}).get(term)
            if tb is None or tn is None:
                continue
            delta = (tn - tb) / tb * 100 if tb else 0.0
            out.append(f"| {arch}/{shape} | {term[:-2]} | {fmt_ms(tb)}ms | {fmt_ms(tn)}ms | {delta:+.1f}% |")
        pb = b.get("memory", {}).get("peak_hbm_bytes")
        pn = n.get("memory", {}).get("peak_hbm_bytes")
        if pb and pn:
            out.append(f"| {arch}/{shape} | peak HBM | {fmt_bytes(pb)} | {fmt_bytes(pn)} | {(pn-pb)/pb*100:+.1f}% |")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--diff", default=None, help="second tag to diff against --tag")
    args = ap.parse_args()
    recs = load(args.tag)
    print(f"# Roofline (single-pod 16x16, H100 figures, {len(recs)} cells loaded, "
          f"tag={args.tag or 'baseline'})\n")
    print("\n".join(roofline_table(recs)))
    print("\n# Multi-pod (2x16x16) compile matrix\n")
    print("\n".join(multipod_table(recs)))
    for pod, name in (("pod1", "single-pod 16x16"), ("pod2", "multi-pod 2x16x16")):
        print(f"\n# Dominant term, bound and peak per rank ({name})\n")
        print("\n".join(cells_table(recs, pod)))
    print("\n# Useful FLOPs and whole-head work per rank\n")
    print("\n".join(flops_table(recs)))
    if args.diff is not None:
        new = load(args.diff)
        cells = sorted({(a, s) for (a, s, p) in new if p == "pod1"})
        print(f"\n# Diff {args.tag or 'baseline'} -> {args.diff}\n")
        print("\n".join(diff_table(recs, new, cells)))


if __name__ == "__main__":
    main()
