"""The one-card dry run (``repro.launch.dryrun``): for every architecture x
input shape, the bytes a step holds on one H100 80GB and its roofline
terms, counted on ``meta`` tensors: nothing is allocated, drawn or run.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out DIR]

Per cell (``run_one``): the config with the reference's long-context
policy (``resolve_config``: pure full-attention archs run ``long_500k``
as their sliding-window variant, whisper-tiny skips it) and server
optimizer (``optimizer_for``); the parameter bytes
(``models.abstract_params``), the optimizer state's (its ``init`` on the
meta tree), the FedAvg step's extra buffers (the accumulator and one
client's copy of the parameters, with that client's gradients), the decode
cache's (``models.init_cache`` on ``meta``), an estimate of the
activations (``activation_bytes``), ``model_flops`` and the roofline
terms of ``roofline.analysis``; whether the cell fits the card, and the
largest depth at which it would.  Each record is written as JSON under
``experiments/dryrun_torch/`` (git-ignored), which ``roofline.report``
renders.

The reference lowers and compiles each step on a 16 x 16 (or 2 x 16 x 16)
TPU mesh and reads XLA's memory and cost analyses.  One card has no mesh
to lay out: ``resolve_strategy`` (tensor- or sequence-parallel prefill),
``make_production_mesh``, the NamedShardings and the lowering have no
counterpart, and eager PyTorch compiles no artefact whose costs could be
read, so the counts here are analytic (``roofline.analysis``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, FLConfig,
                                 OptimizerConfig, get_config)
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import inputs as inp
from repro_torch.models import abstract_params, init_cache, num_params
from repro_torch.optim import make_optimizer
from repro_torch.roofline import analysis as rl

OUT_DIR = (Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
DEVICE = "1xH100"

# long_500k policy (the reference's): pure full-attention archs run it only
# as their sliding-window variant; whisper skips it outright (448-token
# decoder).
WINDOW_VARIANT_FOR_LONG = {"olmo-1b", "yi-6b", "llama3.2-3b", "internvl2-2b"}
SKIP_LONG = {"whisper-tiny"}
LONG_WINDOW = 8192

# a layer's working set in activations, per token, in units of its widest
# width (d_model, or the FFN's hidden width) at the compute dtype: the
# inputs, norms and projections of one layer, with their gradients in
# training (16) and without under prefill's no_grad (6)
LAYER_WORK_WIDTHS = {"train": 16, "prefill": 6}
# the port's adamw keeps six fp32 copies of the parameters at its peak:
# the clipped gradient, m-hat, v-hat, the denominator, the step, the new
# weights (``optim.optimizers._adamw``, multi-tensor lists)
ADAMW_TEMPS = 6


def resolve_config(arch: str, shape_name: str, variant: str = "auto"):
    """Returns (cfg, notes) with the long-context variant policy applied."""
    cfg = get_config(arch)
    notes = []
    if shape_name == "long_500k":
        if arch in SKIP_LONG:
            return None, [f"{arch} skips long_500k (architectural decoder "
                          f"context {cfg.decoder_context})"]
        if arch in WINDOW_VARIANT_FOR_LONG or variant == "window":
            cfg = dataclasses.replace(cfg, layer_pattern=("local",),
                                      sliding_window=LONG_WINDOW)
            notes.append(f"sliding-window variant (w={LONG_WINDOW}) for "
                         "sub-quadratic long-context decode")
    return cfg, notes


def optimizer_for(cfg) -> OptimizerConfig:
    name = "adamw_bf16" if cfg.param_count() > 100e9 else "adamw"
    return OptimizerConfig(name=name, lr=3e-4)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def activation_bytes(cfg, shape, fl: FLConfig) -> int:
    """An estimate of the activations a step holds at once: training with
    block remat keeps each superblock's input, one superblock's working
    set (``LAYER_WORK_WIDTHS`` widths a token a layer; a mamba layer also
    its scan's state checkpoints, every 8th step of (d_inner, n) fp32)
    and the fp32 logits with their softmax and gradient; prefill one
    layer's working set; decode the logits."""
    a = getattr(torch, cfg.compute_dtype).itemsize
    if shape.kind == "decode":
        return shape.global_batch * cfg.vocab_size * 4
    seqs = (shape.global_batch // fl.fl_clients_per_step
            if shape.kind == "train" else shape.global_batch)
    s = shape.seq_len + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    tokens = seqs * s
    ffn = (cfg.experts_per_token * cfg.moe_d_ff if cfg.num_experts
           else cfg.d_ff)
    per_layer = {}
    for kind in set(cfg.layer_kinds):
        b = LAYER_WORK_WIDTHS[shape.kind] * max(cfg.d_model, ffn) * a
        if kind == "mamba":
            b += cfg.ssm_expand * cfg.d_model * cfg.ssm_state_dim * 4 // 8
        per_layer[kind] = b
    plen = len(cfg.layer_pattern)
    superblock = sum(per_layer[k] for k in cfg.layer_kinds[:plen])
    if shape.kind == "prefill":
        return tokens * max(per_layer.values())
    n_sb = cfg.num_layers // plen + cfg.num_layers % plen
    saved = n_sb * tokens * cfg.d_model * a
    logits = 3 * seqs * shape.seq_len * cfg.vocab_size * 4
    return saved + tokens * superblock + logits


def count(cfg, shape, fl: FLConfig, opt: Optional[OptimizerConfig]) -> dict:
    """The cell's bytes on the card (meta tensors only) and its peak: the
    largest of a local step (params, optimizer state, accumulator, one
    client's copy and gradients, activations) and the server update
    (params, old and new optimizer state, accumulator, ``ADAMW_TEMPS``
    fp32 copies); prefill and decode hold the params, the cache and the
    activations."""
    params = abstract_params(cfg)
    p_bytes, n = tree_bytes(params), num_params(params)
    rec = {"params": n, "param_bytes": p_bytes}
    act = activation_bytes(cfg, shape, fl)
    if shape.kind == "train":
        state = make_optimizer(opt, stacked=False)[0](params)
        o_bytes = sum(tree_bytes(t) for t in (state.mu, state.nu) if t)
        fedavg = 2 * p_bytes                 # accumulator, client copy
        local = p_bytes + o_bytes + fedavg + p_bytes + act
        server = p_bytes + 2 * o_bytes + p_bytes + ADAMW_TEMPS * n * 4
        rec.update(opt_state_bytes=o_bytes, fedavg_buffer_bytes=fedavg,
                   grad_bytes=p_bytes, cache_bytes=0,
                   local_step_bytes=local, server_update_bytes=server,
                   total_bytes=max(local, server))
    else:
        cache_len, enc_len = inp.cache_len_for(cfg, shape)
        cache = init_cache(cfg, shape.global_batch, cache_len,
                           enc_len=enc_len, device="meta")
        c_bytes = tree_bytes(cache)
        rec.update(opt_state_bytes=0, fedavg_buffer_bytes=0, grad_bytes=0,
                   cache_bytes=c_bytes,
                   total_bytes=p_bytes + c_bytes + act)
    rec["activation_bytes_estimate"] = act
    rec["fits"] = rec["total_bytes"] <= rl.HBM_BYTES
    return rec


def max_depth_fit(cfg, shape, fl, opt) -> int:
    """The largest depth (``num_layers``, the rest of the config as it
    is) whose count fits the card; 0 when none does."""
    lo, hi = 0, cfg.num_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if count(dataclasses.replace(cfg, num_layers=mid), shape, fl,
                 opt)["fits"]:
            lo = mid
        else:
            hi = mid - 1
    return lo


def run_one(arch: str, shape_name: str, variant: str = "auto",
            save: bool = True, out_dir: Optional[Path] = None,
            fl: Optional[FLConfig] = None, changes: Optional[dict] = None,
            global_batch: Optional[int] = None) -> dict:
    """One cell's record (and its JSON file when ``save``).  ``changes``
    (e.g. a cut depth) and ``global_batch`` resize the cell."""
    t0 = time.perf_counter()
    fl = fl or FLConfig(fl_clients_per_step=4, fl_local_steps=1)
    rec = {"arch": arch, "shape": shape_name, "device": DEVICE,
           "status": "ok", "notes": []}
    try:
        cfg, rec["notes"] = resolve_config(arch, shape_name, variant)
        if cfg is None:
            rec["status"] = "skipped"
            return _finish(rec, t0, save, out_dir)
        if changes:
            cfg = dataclasses.replace(cfg, **changes)
        shape = SHAPES[shape_name]
        if global_batch:
            shape = dataclasses.replace(shape, global_batch=global_batch)
        opt = optimizer_for(cfg) if shape.kind == "train" else None
        rec.update(kind=shape.kind, num_layers=cfg.num_layers,
                   global_batch=shape.global_batch, seq_len=shape.seq_len,
                   param_dtype=cfg.param_dtype,
                   optimizer=opt.name if opt else None,
                   param_count=cfg.param_count(),
                   hbm_bytes=rl.HBM_BYTES, card=rl.CARD,
                   power_limit_w=rl.POWER_LIMIT_W)
        rec.update(count(cfg, shape, fl, opt))
        rec["max_depth_fit"] = (cfg.num_layers if rec["fits"] else
                                max_depth_fit(cfg, shape, fl, opt))
        mf = rl.model_flops(cfg, shape)
        sb = rl.step_bytes(cfg, shape, rec["param_bytes"],
                           rec["cache_bytes"], fl, rec["opt_state_bytes"])
        peak = rl.peak_flops(cfg.compute_dtype)
        rec.update(model_flops=mf, step_bytes=sb, peak_flops=peak,
                   roofline=rl.step_terms(mf, sb["total"], peak))
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _finish(rec, t0, save, out_dir)


def _finish(rec, t0, save, out_dir):
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    if save:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        name = f"{rec['arch']}_{rec['shape']}_{rec['device']}.json"
        (d / name).write_text(json.dumps(rec, indent=1))
    extra = ("" if rec["status"] == "ok" else
             f" ({rec.get('error', '')[:120]})")
    gb = (f" {rec['total_bytes'] / 1e9:9.1f} GB fits={rec['fits']}"
          if rec["status"] == "ok" else "")
    print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['device']} "
          f"{rec['status']:7s}{gb}{extra}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="auto")
    ap.add_argument("--out", default=None,
                    help=f"JSON directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = [run_one(a, s, args.variant, out_dir=args.out)
               for a in archs for s in shapes]
    bad = [r for r in results if r["status"] == "error"]
    print(f"[dryrun] {len(results)} combos: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
