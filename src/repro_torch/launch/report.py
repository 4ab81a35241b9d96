"""Render the dry-run and roofline tables from the dry run's JSON records
(`launch/dryrun.py`) — the port of `repro/launch/report.py`.

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun_torch

A field that a record holds as None (the port's dry run is analytic and
leaves the compiler's numbers empty) prints `n/a`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import ALL_ARCHS

ARCH_ORDER = ALL_ARCHS
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
NA = "n/a"


def load(dirpath: str):
    recs = {}
    for f in glob.glob(os.path.join(dirpath, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        key = (r["arch"], r["shape"], r["mesh"], r.get("policy", "unicaim"))
        recs[key] = r
    return recs


def fmt_b(x):
    if x is None:
        return NA
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def fmt_t(x):
    if x is None:
        return NA
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def _fmt(x, spec: str, suffix: str = "", scale: float = 1.0):
    return NA if x is None else f"{x * scale:{spec}}{suffix}"


def _mix(collectives):
    if collectives is None:
        return NA
    return ",".join(f"{k[:2]}:{fmt_b(v)}"
                    for k, v in sorted(collectives.items())
                    if k != "total" and v > 0)


def dryrun_table(recs, mesh="16x16", policy="unicaim"):
    lines = [
        "| arch | shape | peak/dev | args/dev | flops/dev | HBM bytes/dev |"
        " coll bytes/dev | collective mix | compile |",
        # eight cells under nine headers: the reference's text, kept so
        # that the two packages' tables compare equal
        "|---" * 8 + "|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, policy))
            if not r:
                continue
            lines.append(
                f"| {arch} | {shape} | "
                f"{_fmt(r['peak_bytes_per_dev'], '.2f', 'GiB', 2 ** -30)} | "
                f"{_fmt(r['arg_bytes_per_dev'], '.2f', 'GiB', 2 ** -30)} | "
                f"{_fmt(r['flops'], '.2e')} | {fmt_b(r['bytes_accessed'])} | "
                f"{fmt_b(r['collective_bytes'])} | {_mix(r['collectives'])} | "
                f"{_fmt(r['compile_s'], '.0f', 's')} |")
    return "\n".join(lines)


def roofline_table(recs, mesh="16x16", policy="unicaim"):
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "bound/step | MODEL_FLOPS | useful ratio | MFU bound |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, policy))
            if not r:
                continue
            lines.append(
                f"| {arch} | {shape} | {fmt_t(r['compute_s'])} | "
                f"{fmt_t(r['memory_s'])} | {fmt_t(r['collective_s'])} | "
                f"**{r['dominant'].replace('_s', '')}** | "
                f"{fmt_t(r['step_time_bound_s'])} | "
                f"{_fmt(r['model_flops'], '.2e')} | "
                f"{_fmt(r['useful_flops_ratio'], '.3f')} | "
                f"{_fmt(r['mfu_bound'], '.1f', '%', 100)} |")
    return "\n".join(lines)


def notes_list(recs, mesh="16x16"):
    out = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape, mesh, "unicaim"))
            if r and r.get("notes"):
                out.append(f"- **{arch} × {shape}**: {r['notes']}")
    return "\n".join(sorted(set(out)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--section", default="all",
                    choices=["dryrun", "roofline", "notes", "all"])
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.section in ("dryrun", "all"):
        print("### single-pod (16x16)\n")
        print(dryrun_table(recs, "16x16"))
        print("\n### multi-pod (2x16x16)\n")
        print(dryrun_table(recs, "2x16x16"))
    if args.section in ("roofline", "all"):
        print("\n### roofline (single-pod)\n")
        print(roofline_table(recs, "16x16"))
    if args.section in ("notes", "all"):
        print("\n### per-cell notes\n")
        print(notes_list(recs))


if __name__ == "__main__":
    main()
