"""Markdown tables of the one-card dry run (``repro.roofline.report``), from
``experiments/dryrun_torch/*.json`` (``launch.dryrun``'s records).

    python -m repro_torch.roofline.report [--dir DIR]

``roofline_table`` gives each cell's compute and memory terms on the card
and the dominant one; ``dryrun_table`` its bytes against the card's 80 GB.
The reference's ``multipod_status`` and ``delta_table`` compare the
single-pod against the two-pod lowering, and the baseline against the
optimized profile of that lowering; the port's records of a mesh
(``--mesh``) carry their own counts, and these two tables are not
ported.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import DEVICE, OUT_DIR

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ARCH_ORDER = ("granite-moe-1b-a400m", "internvl2-2b", "granite-moe-3b-a800m",
              "jamba-1.5-large-398b", "gemma3-27b", "whisper-tiny", "olmo-1b",
              "yi-6b", "llama3.2-3b", "rwkv6-3b")


def load(directory=None) -> dict:
    """{(arch, shape): record} of every dry-run JSON in ``directory``."""
    out = {}
    for f in sorted(Path(directory or OUT_DIR).glob(f"*_{DEVICE}.json")):
        rec = json.loads(f.read_text())
        out[(rec["arch"], rec["shape"])] = rec
    return out


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def _rows(recs: dict):
    """(arch, shape, record or None, status cell) in the tables' order."""
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get((arch, shape))
            if r is None:
                yield arch, shape, None, "missing"
            elif r["status"] != "ok":
                note = (r.get("notes") or [r.get("error", "")])[0][:50]
                yield arch, shape, None, f"{r['status']}: {note}"
            else:
                yield arch, shape, r, "ok"


def roofline_table(recs: dict) -> str:
    lines = ["| arch | shape | compute | memory | dominant | MODEL_FLOPS | "
             "status |",
             "|---|---|---|---|---|---|---|"]
    for arch, shape, r, status in _rows(recs):
        if r is None:
            lines.append(f"| {arch} | {shape} | - | - | - | - | {status} |")
            continue
        rf = r["roofline"]
        lines.append(f"| {arch} | {shape} | {_fmt_s(rf['compute_s'])} | "
                     f"{_fmt_s(rf['memory_s'])} | "
                     f"{rf['dominant'].replace('_s', '')} | "
                     f"{r['model_flops']:.3g} | ok |")
    return "\n".join(lines)


def dryrun_table(recs: dict) -> str:
    gb = 1e9
    lines = ["| arch | shape | params GB | opt GB | fedavg GB | cache GB | "
             "act GB (est.) | total GB | fits 80 GB | max depth |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, r, status in _rows(recs):
        if r is None:
            lines.append(f"| {arch} | {shape} | - | - | - | - | - | - | - | "
                         f"{status} |")
            continue
        fed = r["fedavg_buffer_bytes"] + r["grad_bytes"]
        lines.append(
            f"| {arch} | {shape} | {r['param_bytes'] / gb:.2f} | "
            f"{r['opt_state_bytes'] / gb:.2f} | {fed / gb:.2f} | "
            f"{r['cache_bytes'] / gb:.2f} | "
            f"{r['activation_bytes_estimate'] / gb:.2f} | "
            f"{r['total_bytes'] / gb:.2f} | {'yes' if r['fits'] else 'no'} | "
            f"{r['max_depth_fit']} of {r['num_layers']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help=f"dry-run JSON directory (default {OUT_DIR})")
    recs = load(ap.parse_args(argv).dir)
    print(f"## One-card roofline ({DEVICE}, the compute dtype's peak)\n")
    print(roofline_table(recs))
    print(f"\n## One-card dry run ({DEVICE}: bytes against 80 GB)\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
