"""Block stacks for the decoder LM on a stack of K models
(``repro.models.transformer``, train mode).

Layers are grouped into superblocks, one repetition of
``cfg.layer_pattern``; the parameters of the ``n_full`` full repetitions
are stacked along a ``layers`` axis (``params["stack"]["p<i>"]``, leaves
(K, n_full, ...)) and the remainder layers sit under ``params["rem"]``.
The reference scans the stack with ``lax.scan``; the port walks it with a
Python loop.  The reference's ``remat="block"`` (``jax.checkpoint``)
changes no numbers and has no counterpart here.

The port carries the attention layer kinds (``global`` and ``local``,
sliding-window) and the ``mamba`` layer kind, each with a dense or an MoE
FFN (``cfg.ffn_is_moe``), and the ``rwkv`` layer kind (time-mix and
channel-mix, from zero states).  The MoE FFN's load-balancing loss is per
model: ``forward_train`` returns aux of shape (K,), each entry from that
model's own tokens, as the reference's loss vmapped over clients gives.
The audio/vlm frontends and the prefill/decode caches raise
``NotImplementedError`` (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.kernels.window_attn.ops import window_attention
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       apply_rope, apply_unembed, init_embed,
                                       init_mlp, init_norm, matmul)

KINDS = ("global", "local", "mamba", "rwkv")


def check_kinds(cfg: ModelConfig) -> None:
    """Raise for the layer kinds and frontends not ported yet."""
    if cfg.family in ("audio", "vlm") or cfg.frontend:
        raise NotImplementedError(f"the {cfg.family!r} family's frontend is "
                                  f"not ported yet (ROADMAP queue 1 item 5)")
    for kind in cfg.layer_kinds:
        if kind not in KINDS:
            raise ValueError(kind)


def pattern_info(cfg: ModelConfig) -> Tuple[int, int, int]:
    plen = len(cfg.layer_pattern)
    n_full = cfg.num_layers // plen
    rem = cfg.num_layers % plen
    if cfg.num_experts and n_full > 1:
        assert plen % cfg.moe_every == 0, (
            "layer_pattern length must be a multiple of moe_every so the "
            "MoE placement is identical across stacked superblocks")
    return plen, n_full, rem


class _Stacked:
    """Wraps a factory, prepending a (n,) 'layers' dim to every param.  A
    normal leaf's fan_in comes from the unstacked shape, as the
    reference's ``_Stacked`` computes it."""

    def __init__(self, fac, n: int):
        self.fac, self.n = fac, n

    def param(self, shape, init="normal", scale=1.0, in_dims=1, fan_in=None):
        if fan_in is None and init == "normal":
            fan_in = (int(np.prod(shape[:in_dims])) if len(shape) > 1
                      else max(shape[-1], 1))
        return self.fac.param((self.n,) + tuple(shape), init=init,
                              scale=scale, fan_in=fan_in)


def _init_block(fac, cfg: ModelConfig, kind: str, pat_idx: int):
    if kind == "rwkv":        # no ffn: channel-mix is the rwkv layer's FFN
        return {"ln1": init_norm(fac, cfg), "ln2": init_norm(fac, cfg),
                "rwkv": rw.init_rwkv(fac, cfg)}
    if kind in ("global", "local"):
        mixer = {"attn": attn.init_attention(fac, cfg)}
    elif kind == "mamba":
        mixer = {"mamba": mb.init_mamba(fac, cfg)}
    else:                     # check_kinds has refused the others
        raise ValueError(kind)
    ffn = init_moe(fac, cfg) if cfg.ffn_is_moe(pat_idx) else init_mlp(fac,
                                                                       cfg)
    return {"ln1": init_norm(fac, cfg), **mixer, "ln2": init_norm(fac, cfg),
            "ffn": ffn}


def _attention(p, h, cfg: ModelConfig, kind: str) -> torch.Tensor:
    """q/k/v projections, RoPE, attention and the output projection of a
    stack of K models: h (K, bs, S, d) -> (K, bs, S, d).  The model axis
    folds into the batch for the attention, which holds no parameters."""
    km, bs, s, d = h.shape
    hh, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(w, heads):
        return matmul(h, w.reshape(km, d, heads * hd)).reshape(
            km * bs, s, heads, hd)
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None]
    q = apply_rope(proj(p["wq"], hh), positions, cfg.rope_theta)
    k = apply_rope(proj(p["wk"], kv), positions, cfg.rope_theta)
    v = proj(p["wv"], kv)
    if kind == "local" and cfg.sliding_window and s > cfg.sliding_window:
        o = window_attention(q, k, v, cfg.sliding_window).to(q.dtype)
    else:
        win = cfg.sliding_window if kind == "local" else 0
        if cfg.attn_block_skip:
            o = attn.causal_skip_attention(q, k, v, window=win)
        else:
            o = attn.blockwise_attention(q, k, v, causal=True, window=win,
                                         block_q=cfg.attn_block_q or s)
    return matmul(o.reshape(km, bs, s, hh * hd),
                  p["wo"].reshape(km, hh * hd, d))


def init_lm(fac, cfg: ModelConfig):
    """Full parameter tree of one LM (no model axis)."""
    check_kinds(cfg)
    plen, n_full, rem = pattern_info(cfg)
    params: Dict[str, Any] = {"embed": init_embed(fac, cfg)}
    stack: Dict[str, Any] = {}
    if n_full:
        sfac = _Stacked(fac, n_full)
        for pidx, kind in enumerate(cfg.layer_pattern):
            stack[f"p{pidx}"] = _init_block(sfac, cfg, kind, pidx)
    params["stack"] = stack
    params["rem"] = {f"r{j}": _init_block(
        fac, cfg, cfg.layer_kinds[n_full * plen + j], j % plen)
        for j in range(rem)}
    params["final_ln"] = init_norm(fac, cfg)
    return params


def _apply_ffn(p, x, cfg: ModelConfig, is_moe: bool):
    """The dense or MoE FFN: x (K, bs, S, d) -> (y, aux (K,))."""
    if is_moe:
        y, aux = apply_moe(p, x, cfg)
        return y, aux.float()
    return apply_mlp(p, x, cfg), x.new_zeros((x.shape[0],),
                                             dtype=torch.float32)


def apply_block_train(p, x, cfg: ModelConfig, kind: str, pat_idx: int):
    """One layer in train mode: x (K, bs, S, d) -> (x, aux (K,))."""
    aux = x.new_zeros((x.shape[0],), dtype=torch.float32)
    if kind == "rwkv":
        km, bs, _, d = x.shape
        hh, nn = rw.rwkv_heads(cfg)
        prev = torch.zeros((km, bs, d), dtype=x.dtype, device=x.device)
        h0 = torch.zeros((km, bs, hh, nn, nn), dtype=torch.float32,
                         device=x.device)
        x, _state = rw.rwkv_block(
            p["rwkv"], x, cfg, (prev, h0, prev),
            lambda i, v: apply_norm(p[("ln1", "ln2")[i]], v, cfg))
        return x, aux
    h = apply_norm(p["ln1"], x, cfg)
    if kind in ("global", "local"):
        x = x + _attention(p["attn"], h, cfg, kind)
    elif kind == "mamba":
        x = x + mb.mamba_block(p["mamba"], h, cfg)[0]
    else:                     # check_kinds has refused the others
        raise ValueError(kind)
    y, aux = _apply_ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg,
                        cfg.ffn_is_moe(pat_idx))
    return x + y, aux


def forward_train(params, cfg: ModelConfig, batch):
    """Returns (logits (K, bs, S, V), aux_loss (K,)).  batch: tokens
    (K, bs, S)."""
    check_kinds(cfg)
    plen, n_full, rem = pattern_info(cfg)
    x = apply_embed(params["embed"], batch["tokens"], cfg).to(
        getattr(torch, cfg.compute_dtype))
    aux_total = x.new_zeros((x.shape[0],), dtype=torch.float32)
    # each stacked leaf (K, n_full, ...) split once into its n_full layers
    layers = {f"p{pidx}": tree_map(lambda v: v.unbind(1),
                                   params["stack"][f"p{pidx}"])
              for pidx in range(plen)} if n_full else {}
    for layer in range(n_full):
        for pidx, kind in enumerate(cfg.layer_pattern):
            p = tree_map(lambda vs: vs[layer], layers[f"p{pidx}"])
            x, aux = apply_block_train(p, x, cfg, kind, pidx)
            aux_total = aux_total + aux
    for j in range(rem):
        kind = cfg.layer_kinds[n_full * plen + j]
        x, aux = apply_block_train(params["rem"][f"r{j}"], x, cfg, kind,
                                   j % plen)
        aux_total = aux_total + aux
    x = apply_norm(params["final_ln"], x, cfg)
    return apply_unembed(params["embed"], x, cfg), aux_total
