#!/usr/bin/env python3
"""Serve a few reduced configs sharded over a (2, 2) mesh of four CPU ranks
(``gloo``) and hold them to plain serving on the CPU, with whatever torch
is installed: ``python3 tools/mesh_serve_gloo.py [--out FILE]``.

The split layouts of ``launch.serve`` (slots over ``model`` or over
``data`` x ``model``, sequence-parallel prefill rows, FSDP weights) only
show on a mesh of more than one rank.  The tests hold them to the JAX
reference; this script needs no JAX, so it runs where only the port is
installed.  Each case: ``reduce_for_smoke`` of the arch with its changes,
weights from ``init_params(cfg, 0)``, a batch of ``ROWS`` random prompts
and ``GEN`` teacher-forced decode steps, served once through
``serve_on_mesh`` (a world of its own a case, so that one case's failure
hides no other's) and once through the unsharded ``make_prefill_step`` /
``make_decode_step``.  A case passes when every logit and cache leaf
agrees within rtol 1e-4 / atol 1e-4 (positions exactly), an attention
case splits its decode cache along the slot axis, and every decode step
keeps the cache's placements.  Prints the torch version, then one JSON
line a case (its error, if it failed), then a summary line; exits 1 if a
case failed.  ``--only ID ...`` runs some of the cases.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MESH = "2x2"
GEN = 4
TOL = dict(rtol=1e-4, atol=1e-4)
KV_LEAVES = ("k", "v", "xk", "xv")
# id -> (arch, prompt, changes, strategy, rows, cache headroom)
CASES = {
    "gemma3-window16": ("gemma3-27b", 40, {"sliding_window": 16}, "auto", 2,
                        True),
    "llama3.2-3b": ("llama3.2-3b", 24, {}, "auto", 2, True),
    "llama3.2-3b-tp": ("llama3.2-3b", 24, {}, "tp", 2, True),
    "gemma3-batch1": ("gemma3-27b", 24, {}, "auto", 1, True),
    "jamba-batch1": ("jamba-1.5-large-398b", 24, {}, "auto", 1, True),
    "olmo-no-headroom": ("olmo-1b", 24, {}, "auto", 2, False),
    "granite-moe-3b": ("granite-moe-3b-a800m", 24, {}, "auto", 2, True),
    "rwkv6-3b": ("rwkv6-3b", 24, {}, "auto", 2, True),
}


def case_inputs(cid):
    """(cfg, weights, batch, feed, max_len) of a case, as numpy."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import init_params, to_numpy_params
    arch, prompt, changes, _, rows, headroom = CASES[cid]
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes)
    weights = to_numpy_params(init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (rows, prompt + GEN)).astype(
        np.int32)
    return (cfg, weights, {"tokens": toks[:, :prompt]}, toks[:, prompt:],
            prompt + GEN if headroom else None)


def plain_serve(cfg, weights, batch, feed, max_len):
    """[(logits, cache)] of prefill and each step, unsharded, as numpy (a
    copy of each cache: a decode step writes its cache in place)."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import from_numpy_params, to_numpy_params

    def snap(cache):
        return tree_map(np.copy, to_numpy_params(cache))
    params = from_numpy_params(weights, device="cpu")
    logits, cache = make_prefill_step(cfg, max_len=max_len)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    out = [(logits.numpy(), snap(cache))]
    decode = make_decode_step(cfg)
    for i in range(feed.shape[1]):
        logits, cache = decode(params, torch.from_numpy(feed[:, i:i + 1]),
                               cache)
        out.append((logits.numpy(), snap(cache)))
    return out


def worst_gap(got, want, what):
    """The largest |got - want| over a tree; raises past TOL (positions
    exactly)."""
    from repro_torch.core.tree import leaves_with_paths
    want_leaves = dict(leaves_with_paths(want))
    worst = 0.0
    for path, g in leaves_with_paths(got):
        w = want_leaves[path]
        name = "/".join(path)
        if name.endswith("pos"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **TOL)
        worst = max(worst, float(np.abs(g.astype(np.float64) - w).max()))
    return worst


def check(cid, port, ref) -> dict:
    arch = CASES[cid][0]
    from repro_torch.configs import get_config
    gaps = []
    for i, (logits, cache) in enumerate(ref):
        what = "prefill" if i == 0 else f"decode step {i}"
        gaps.append(max(worst_gap({"logits": port["logits"][i]},
                                  {"logits": logits}, what),
                        worst_gap(port["caches"][i], cache, what)))
    dec = port["placements"][1]
    attention = any(k in ("global", "local")
                    for k in get_config(arch).layer_kinds)
    slot_split = sorted(p for p, pl in dec.items()
                        if p.split("/")[-1] in KV_LEAVES and "S(2)" in pl)
    if bool(slot_split) != attention:
        raise AssertionError(f"{cid}: slot split {slot_split} ({dec})")
    for i, pl in enumerate(port["placements"][2:]):
        if pl != dec:
            raise AssertionError(f"{cid}: step {i} moved the cache ({pl})")
    return {"case": cid, "strategy": port["strategy"],
            "max_abs_gap": max(gaps), "slot_split_leaves": len(slot_split),
            "prefill_placements": sorted({str(v) for v in
                                          port["placements"][0].values()}),
            "decode_placements": sorted({str(v) for v in dec.values()})}


def main(argv=None) -> int:
    import torch

    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.serve import serve_on_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, choices=sorted(CASES))
    ap.add_argument("--out", default=None,
                    help="also write the lines as JSON to this file")
    args = ap.parse_args(argv)
    print(json.dumps({"torch": torch.__version__, "mesh": MESH,
                      "backend": "gloo", "device": "cpu"}))
    rows = []
    for cid in args.only or CASES:
        cfg, w, b, f, m = inputs = case_inputs(cid)
        case = dict(arch=CASES[cid][0], changes=CASES[cid][2],
                    strategy=CASES[cid][3], weights=w, batch=b, feed=f,
                    max_len=m)
        t0 = time.perf_counter()
        try:
            got = spawn(serve_on_mesh, 4, "gloo", [case], MESH, "cpu",
                        timeout=600)[0]
            row = check(cid, got, plain_serve(*inputs))
        except Exception as e:  # noqa: BLE001 — reported, the rest run on
            row = {"case": cid, "error": f"{type(e).__name__}: {e}"[-4000:]}
        row["world_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    failed = [r["case"] for r in rows if "error" in r]
    summary = {"ok": not failed, "cases": len(rows), "failed": failed,
               "torch": torch.__version__}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, **summary},
                                             indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
