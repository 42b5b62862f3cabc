"""The dry run (``repro.launch.dryrun``): for every architecture x input
shape, the bytes a step holds on each H100 80GB of a mesh (one card by
default) and its roofline terms, counted on ``meta`` tensors: nothing is
allocated, drawn or run.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out DIR]
    python -m repro_torch.launch.dryrun --all --mesh 16x16 [--strategy auto]
    python -m repro_torch.launch.dryrun --all --both-meshes --profile optimized

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

With ``--mesh`` (16x16, 2x16x16 or any DxM / PxDxM) the same counts are
per device: each leaf of the params, optimizer state, batch and decode
cache at its shard's shape under the reference's policy
(``launch.shardings``; ``resolve_strategy`` picks tensor- or
sequence-parallel prefill as the reference's does), read from the
placements' specs, with no process group; the activations are divided
over the batch's shards.  The cell's step at a reduced depth
(``TRACE_SUPERBLOCKS`` superblocks) is then run on ``meta`` DTensors in a
``fake_world`` of the mesh's size, the kernels swapped for elementwise
stand-ins of their shapes: one FedAvg step for a train cell, prefill of
the cell's batch under prefill's strategy for a prefill cell, one decode
step against the cell's cache in decode's ``cache_shardings`` for a
decode cell (the reference's ``build_lowered`` branches); and
``CommDebugMode`` (``roofline.analysis.CollectiveTrace``) counts its
collectives: their
link bytes by kind, the reference's ``parse_collectives`` record, and a
collective term over NVLink.  The record's ``mesh`` names the mesh as the
reference's does.  The reference lowers and compiles each step and reads
XLA's memory and cost analyses; eager PyTorch compiles no such artefact,
so the counts here are analytic (``roofline.analysis``).

``--profile`` picks the reference's ``PROFILES``: "baseline" (the
published configs, tensor-parallel prefill) or "optimized" (triangle block
skipping and bf16 ssm chunks as config overrides, the "auto" strategy),
the records of the latter written with the reference's ``_opt`` suffix.
The reference's ``--multi-pod`` is ``--mesh 2x16x16`` here and
``--both-meshes`` runs 16x16 and 2x16x16.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, FLConfig,
                                 OptimizerConfig, get_config)
from repro_torch.core.tree import leaves_with_paths, tree_leaves
from repro_torch.launch import inputs as inp
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import mesh_name, parse_mesh
from repro_torch.launch.shardings import (  # noqa: F401
    SEQPAR_MAX_PARAMS, resolve_strategy)
from repro_torch.models import abstract_params, init_cache, num_params
from repro_torch.models.params import local_shape
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


TRACE_SUPERBLOCKS = 1     # the collective trace's depth, in superblocks


def tree_bytes(tree, specs=None, mesh=None) -> int:
    """A tree's bytes, or with ``specs`` (a tree of the same keys) each
    leaf's shard's on ``mesh``."""
    if specs is None:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    sp = dict(leaves_with_paths(specs))
    return sum(int(np.prod(local_shape(tuple(t.shape), sp[p], mesh)))
               * t.element_size() for p, t in leaves_with_paths(tree))


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


class Layout:
    """Where a cell's leaves live: one card (``mesh`` None) or each device
    of a mesh under the reference's rules for the cell's kind and
    strategy."""

    def __init__(self, mesh=None, kind: str = "train", strategy: str = "tp",
                 published=None):
        self.mesh = mesh
        if mesh is not None:
            multi = "pod" in mesh.mesh_dim_names
            self.prules = sh.param_rules(published, kind, multi, strategy)
            self.arules = sh.act_rules(published, kind, multi, strategy)

    def params(self, cfg, tree):
        if self.mesh is None:
            return tree_bytes(tree)
        return tree_bytes(tree, sh.param_specs(cfg, self.mesh, self.prules,
                                               abstract=tree), self.mesh)

    def numel(self, cfg, tree):
        """Parameters on one device."""
        if self.mesh is None:
            return num_params(tree)
        sp = dict(leaves_with_paths(sh.param_specs(cfg, self.mesh,
                                                   self.prules, tree)))
        return sum(int(np.prod(local_shape(tuple(t.shape), sp[p],
                                           self.mesh)))
                   for p, t in leaves_with_paths(tree))

    def batch(self, tree, client_leading: bool):
        if self.mesh is None:
            return tree_bytes(tree)
        return tree_bytes(tree, sh.batch_specs(tree, self.mesh, self.arules,
                                               client_leading), self.mesh)

    def cache(self, tree):
        if self.mesh is None:
            return tree_bytes(tree)
        return tree_bytes(tree, sh.cache_specs(tree, self.mesh,
                                               self.arules), self.mesh)

    def batch_parts(self, tokens, client_leading: bool) -> int:
        """How many shards the batch's sequences are cut into."""
        if self.mesh is None:
            return 1
        full = int(np.prod(tokens.shape))
        return full // int(np.prod(local_shape(
            tuple(tokens.shape), sh.batch_specs(
                {"tokens": tokens}, self.mesh, self.arules,
                client_leading)["tokens"], self.mesh)))


def count(cfg, shape, fl: FLConfig, opt: Optional[OptimizerConfig],
          layout: Optional[Layout] = None) -> dict:
    """The cell's bytes on the card, or on each device of ``layout``'s
    mesh (meta tensors only), and its peak: the largest of a local step
    (params, optimizer state, accumulator, one client's copy and
    gradients, activations) and the server update (params, old and new
    optimizer state, accumulator, ``ADAMW_TEMPS`` fp32 copies); prefill
    and decode hold the params, the cache and the activations."""
    layout = layout or Layout()
    params = abstract_params(cfg)
    p_bytes, n = layout.params(cfg, params), layout.numel(cfg, params)
    rec = {"params": num_params(params), "param_bytes": p_bytes}
    act = activation_bytes(cfg, shape, fl)
    if shape.kind == "train":
        state = make_optimizer(opt, stacked=False)[0](params)
        o_bytes = sum(layout.params(cfg, t) for t in (state.mu, state.nu)
                      if t)
        b = inp.train_batch_specs(cfg, shape, fl)
        act //= layout.batch_parts(b["tokens"], True)
        fedavg = 2 * p_bytes                 # accumulator, client copy
        local = p_bytes + o_bytes + fedavg + p_bytes + act
        server = p_bytes + 2 * o_bytes + p_bytes + ADAMW_TEMPS * n * 4
        rec.update(opt_state_bytes=o_bytes, fedavg_buffer_bytes=fedavg,
                   grad_bytes=p_bytes, cache_bytes=0,
                   batch_bytes=layout.batch(b, True),
                   local_step_bytes=local, server_update_bytes=server,
                   total_bytes=max(local, server))
    else:
        cache_len, enc_len = inp.cache_len_for(cfg, shape)
        cache = init_cache(cfg, shape.global_batch, cache_len,
                           enc_len=enc_len, device="meta")
        c_bytes = layout.cache(cache)
        b = (inp.prefill_batch_specs(cfg, shape) if shape.kind == "prefill"
             else {"tokens": inp.decode_token_specs(shape)})
        act //= layout.batch_parts(b["tokens"], False)
        rec.update(opt_state_bytes=0, fedavg_buffer_bytes=0, grad_bytes=0,
                   cache_bytes=c_bytes, batch_bytes=layout.batch(b, False),
                   total_bytes=p_bytes + c_bytes + act)
    rec["activation_bytes_estimate"] = act
    rec["fits"] = rec["total_bytes"] <= rl.HBM_BYTES
    return rec


def max_depth_fit(cfg, shape, fl, opt, layout=None) -> int:
    """The largest depth (``num_layers``, the rest of the config as it
    is) whose count fits the card (each device of ``layout``'s mesh); 0
    when none does."""
    lo, hi = 0, cfg.num_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if count(dataclasses.replace(cfg, num_layers=mid), shape, fl,
                 opt, layout)["fits"]:
            lo = mid
        else:
            hi = mid - 1
    return lo


# ---------------------------------------------------------------------------
# The collectives of one sharded step
# ---------------------------------------------------------------------------

def _ssm_shape(dt, b, c, x, a, h0):
    """``ssm_scan``'s outputs from elementwise ops on every input."""
    return (dt + x + (b + c).sum(-1, keepdim=True),
            h0 + a.sum(0, keepdim=True))


def _wkv_shape(r, k, v, lw, u, h0):
    u4 = u.reshape(-1, 1, *u.shape[-2:]).sum(0, keepdim=True)
    return r + k + v + lw + u4, h0 + u4[:, 0, :, :, None]


def _window_shape(q, k, v, window):
    return q + (k + v).mean(2, keepdim=True)


@contextlib.contextmanager
def _shape_kernels():
    """The recurrence and window kernels swapped for elementwise stand-ins
    of their shapes (each output reached from every input, so backward
    runs through them): a meta trace then walks no time loop."""
    from repro_torch.models import attention, mamba, rwkv6
    saved = (mamba.ssm_scan, rwkv6.wkv, attention.window_attention)
    mamba.ssm_scan, rwkv6.wkv = _ssm_shape, _wkv_shape
    attention.window_attention = _window_shape
    try:
        yield
    finally:
        mamba.ssm_scan, rwkv6.wkv, attention.window_attention = saved


def _traced_step(cfg, shape, fl: FLConfig, opt, mesh, prules, arules):
    """The cell's step on ``meta`` DTensors laid out on ``mesh`` by the
    rules, as a thunk: one FedAvg step (train), prefill of the cell's
    batch (prefill), or one decode step against a cache of the cell's
    length in decode's ``cache_shardings`` (decode)."""
    from repro_torch.launch.train import make_fedavg_step
    from repro_torch.models import ShardCtx, decode_fn, prefill_fn
    from repro_torch.optim import OptState
    ctx = ShardCtx(mesh, arules)
    params = abstract_params(cfg)
    psh = sh.param_shardings(cfg, mesh, prules, abstract=params)
    dp = sh.distribute_tree(params, psh, mesh)
    if shape.kind == "train":
        state = make_optimizer(opt, stacked=False)[0](params)
        osh = sh.opt_state_shardings(state, psh, mesh)
        moments = [None if t is None else sh.distribute_tree(t, o, mesh)
                   for t, o in ((state.mu, osh.mu), (state.nu, osh.nu))]
        b = inp.train_batch_specs(cfg, shape, fl)
        db = sh.distribute_tree(b, sh.batch_shardings(
            b, mesh, arules, client_leading=True), mesh)
        step = make_fedavg_step(cfg, fl, opt, ctx)
        return lambda: step((dp, OptState(0, *moments)), db)
    if shape.kind == "prefill":
        b = inp.prefill_batch_specs(cfg, shape)
        db = sh.distribute_tree(b, sh.batch_shardings(b, mesh, arules), mesh)
        return lambda: prefill_fn(cfg, ctx)(dp, db)
    cache_len, enc_len = inp.cache_len_for(cfg, shape)
    cache = init_cache(cfg, shape.global_batch, cache_len, enc_len=enc_len,
                       device="meta")
    dc = sh.distribute_tree(cache, sh.cache_shardings(cache, mesh, arules),
                            mesh)
    tok = {"tokens": inp.decode_token_specs(shape)}
    dt = sh.distribute_tree(tok, sh.batch_shardings(tok, mesh, arules),
                            mesh)["tokens"]
    return lambda: decode_fn(cfg, ctx)(dp, dt, dc)


def trace_collectives(cfg, published, shape, fl: FLConfig, opt,
                      mesh_shape, strategy: str = "tp") -> dict:
    """The cell's step (``_traced_step``: a FedAvg step, prefill or one
    decode step) of ``cfg`` on ``meta`` DTensors laid out on a mesh of
    ``mesh_shape`` in a ``fake_world`` of its size, under ``published``'s
    rules for the cell's kind and ``strategy``; its collectives
    (``roofline.analysis``)."""
    from repro_torch.launch.mesh import fake_world, make_mesh
    n_dev = int(np.prod(mesh_shape.shape))
    multi = "pod" in mesh_shape.mesh_dim_names
    with fake_world(n_dev), _shape_kernels():
        mesh = make_mesh(mesh_shape.shape, mesh_shape.mesh_dim_names, "cpu")
        step = _traced_step(
            cfg, shape, fl, opt, mesh,
            sh.param_rules(published, shape.kind, multi, strategy),
            sh.act_rules(published, shape.kind, multi, strategy))
        trace = rl.CollectiveTrace()
        with trace:
            step()
    return rl.collectives_of(trace, n_dev)


# the reference's profiles (``repro.launch.dryrun.PROFILES``)
PROFILES = {
    # paper-faithful: masked-full attention blocks, f32 scan internals, TP
    "baseline": {"overrides": {}, "strategy": "tp"},
    # beyond-paper: triangle block skipping, bf16 ssm chunks, auto
    # sequence-parallel prefill
    "optimized": {"overrides": {"attn_block_skip": True,
                                "ssm_chunk_dtype": "bfloat16"},
                  "strategy": "auto"},
}


def run_one(arch: str, shape_name: str, variant: str = "auto",
            save: bool = True, out_dir: Optional[Path] = None,
            fl: Optional[FLConfig] = None, changes: Optional[dict] = None,
            global_batch: Optional[int] = None, mesh: Optional[str] = None,
            strategy: str = "tp", collectives: bool = True,
            seq_len: Optional[int] = None, overrides: Optional[dict] = None,
            tag: str = "") -> dict:
    """One cell's record (and its JSON file when ``save``, its name ending
    in ``tag``).  ``overrides`` change the published config (a profile's,
    ``PROFILES``); ``changes`` (e.g. a cut depth), ``global_batch`` and
    ``seq_len`` resize the cell; ``mesh`` ("16x16", "2x16x16", "DxM")
    counts each device of that mesh under the reference's policy and
    ``strategy`` ("tp", "seq_parallel" or "auto"); ``collectives`` traces
    the cell's step there (a FedAvg step, prefill or one decode step)."""
    t0 = time.perf_counter()
    fl = fl or FLConfig(fl_clients_per_step=4, fl_local_steps=1)
    rec = {"arch": arch, "shape": shape_name, "device": DEVICE,
           "status": "ok", "notes": []}
    if mesh:
        rec.update(mesh=mesh_name(parse_mesh(mesh)), strategy=strategy)
    if overrides:
        rec["overrides"] = dict(overrides)
    try:
        cfg, rec["notes"] = resolve_config(arch, shape_name, variant)
        if cfg is None:
            rec["status"] = "skipped"
            return _finish(rec, t0, save, out_dir, tag)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        shape = SHAPES[shape_name]
        layout = None
        if mesh:
            ms = parse_mesh(mesh)
            strategy = resolve_strategy(cfg, shape.kind, strategy)
            if strategy == "seq_parallel":
                # q must stay a single shardable dim
                cfg = dataclasses.replace(cfg, attn_block_q=0,
                                          attn_block_skip=False)
                rec["notes"].append("seq_parallel prefill (head counts "
                                    "don't divide the model dim)")
            layout = Layout(ms, shape.kind, strategy, cfg)
            rec.update(strategy=strategy, num_devices=int(np.prod(ms.shape)))
        published = cfg
        if changes:
            cfg = dataclasses.replace(cfg, **changes)
        if global_batch:
            shape = dataclasses.replace(shape, global_batch=global_batch)
        if seq_len:
            shape = dataclasses.replace(shape, seq_len=seq_len)
        opt = optimizer_for(cfg) if shape.kind == "train" else None
        rec.update(kind=shape.kind, num_layers=cfg.num_layers,
                   global_batch=shape.global_batch, seq_len=shape.seq_len,
                   param_dtype=cfg.param_dtype,
                   optimizer=opt.name if opt else None,
                   param_count=cfg.param_count(),
                   hbm_bytes=rl.HBM_BYTES, card=rl.CARD,
                   power_limit_w=rl.POWER_LIMIT_W)
        rec.update(count(cfg, shape, fl, opt, layout))
        rec["max_depth_fit"] = (cfg.num_layers if rec["fits"] else
                                max_depth_fit(cfg, shape, fl, opt, layout))
        if layout is not None and collectives:
            depth = TRACE_SUPERBLOCKS * len(cfg.layer_pattern)
            rec["collective_trace_layers"] = depth
            rec.update(trace_collectives(
                dataclasses.replace(cfg, num_layers=depth), published,
                shape, fl, opt, ms, strategy))
            rec["collective_s"] = (rec["collective_bytes_total"]
                                   / (rec["num_devices"] * rl.NVLINK_BW))
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
    return _finish(rec, t0, save, out_dir, tag)


def _finish(rec, t0, save, out_dir, tag: str = ""):
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    if save:
        d = Path(out_dir or OUT_DIR)
        d.mkdir(parents=True, exist_ok=True)
        where = rec.get("mesh", rec["device"])
        name = f"{rec['arch']}_{rec['shape']}_{where}{tag}.json"
        (d / name).write_text(json.dumps(rec, indent=1))
    extra = ("" if rec["status"] == "ok" else
             f" ({rec.get('error', '')[:120]})")
    gb = (f" {rec['total_bytes'] / 1e9:9.1f} GB fits={rec['fits']}"
          if rec["status"] == "ok" else "")
    where = rec.get("mesh", rec["device"])
    print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {where:8s} "
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
    ap.add_argument("--mesh", default=None,
                    help="16x16, 2x16x16 or DxM: count each device")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's flag: --mesh 2x16x16")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the reference's flag: 16x16 and 2x16x16")
    ap.add_argument("--profile", default="baseline", choices=list(PROFILES))
    ap.add_argument("--strategy", default=None,
                    choices=("tp", "seq_parallel", "auto"),
                    help="default: the profile's")
    ap.add_argument("--no-collectives", action="store_true",
                    help="skip the cells' collective trace")
    args = ap.parse_args(argv)
    prof = PROFILES[args.profile]
    tag = "" if args.profile == "baseline" else "_opt"
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["16x16", "2x16x16"] if args.both_meshes
              else ["2x16x16"] if args.multi_pod else [args.mesh])
    results = [run_one(a, s, args.variant, out_dir=args.out, mesh=m,
                       strategy=args.strategy or prof["strategy"],
                       collectives=not args.no_collectives,
                       overrides=prof["overrides"], tag=tag)
               for a in archs for s in shapes for m in meshes]
    bad = [r for r in results if r["status"] == "error"]
    print(f"[dryrun] {len(results)} combos: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
