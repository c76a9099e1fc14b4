"""Render tables from the dry run's reports (``reports/dryrun_torch/*.json``).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single16x16]

The port's counterpart of ``repro.launch.report``; its fit column is the
H100's 80 GB (``fits_80gb_hbm``) and its memory column the rank's peak in GB.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"

ARCH_ORDER = ["smollm-135m", "smollm-360m", "olmo-1b", "internlm2-1.8b",
              "llava-next-34b", "whisper-medium", "mamba2-130m", "hymba-1.5b",
              "mixtral-8x7b", "arctic-480b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, tagged: bool = False, reports: Path | None = None) -> list[dict]:
    rows = []
    for f in sorted((reports or REPORTS).glob("*.json")):
        parts = f.stem.split("__")
        is_tagged = len(parts) > 3
        if is_tagged != tagged:
            continue
        d = json.loads(f.read_text())
        if d.get("mesh") != mesh:
            continue
        d["tag"] = parts[3] if is_tagged else ""
        rows.append(d)
    rows.sort(key=lambda r: (ARCH_ORDER.index(r["arch"]),
                             SHAPE_ORDER.index(r["shape"])))
    return rows


def md_table(rows: list[dict]) -> str:
    hdr = ("| arch | cell | t_comp (ms) | t_mem (ms) | t_coll (ms) | bound | "
           "useful | roofline-frac | HBM GB/dev | fits 80G |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']}{('/' + r['tag']) if r.get('tag') else ''} "
            f"| {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
            f"| {r['t_collective_s']*1e3:.2f} | {r['bottleneck']} "
            f"| {r['useful_ratio']:.3f} | {r['roofline_fraction']*100:.1f}% "
            f"| {r['memory']['per_device_gb']:.2f} "
            f"| {'✓' if r['fits_80gb_hbm'] else '✗'} |")
    return "\n".join(out)


def collectives_table(rows: list[dict]) -> str:
    hdr = "| arch | cell | all-gather | all-reduce | reduce-scatter | all-to-all | permute |"
    out = [hdr, "|" + "---|" * 7]
    for r in rows:
        c = r["coll_bytes"]
        gib = lambda k: f"{c.get(k, 0)/2**30:.2f}"  # noqa: E731
        out.append(f"| {r['arch']} | {r['shape']} | {gib('all-gather')} "
                   f"| {gib('all-reduce')} | {gib('reduce-scatter')} "
                   f"| {gib('all-to-all')} | {gib('collective-permute')} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single16x16")
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--tagged", action="store_true", help="perf variants")
    args = ap.parse_args(argv)
    rows = load(args.mesh, tagged=args.tagged)
    if not rows:
        print(f"(no reports for mesh {args.mesh})")
        return 1
    print(md_table(rows))
    if args.collectives:
        print()
        print(collectives_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
