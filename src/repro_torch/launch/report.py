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
    if args.diff is not None:
        new = load(args.diff)
        cells = sorted({(a, s) for (a, s, p) in new if p == "pod1"})
        print(f"\n# Diff {args.tag or 'baseline'} -> {args.diff}\n")
        print("\n".join(diff_table(recs, new, cells)))


if __name__ == "__main__":
    main()
