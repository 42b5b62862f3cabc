"""Block stacks on a stack of K models (``repro.models.transformer``): the
decoder LM (dense / MoE / hybrid / ssm), the encoder-decoder (audio) and
the vision-prefix LM (vlm), in three modes:
  train    -> logits over the full sequence (plus the MoE aux loss)
  prefill  -> last-token logits and a populated decode cache
  decode   -> one-token step against the cache

Layers are grouped into superblocks, one repetition of
``cfg.layer_pattern``; the parameters of the ``n_full`` full repetitions
are stacked along a ``layers`` axis (``params["stack"]["p<i>"]``, leaves
(K, n_full, ...)) and the remainder layers sit under ``params["rem"]``.
The reference scans the stack with ``lax.scan``; the port walks it with a
Python loop.  ``forward_train(..., remat="block")`` (or ``"full"``, the
same) runs each superblock under ``torch.utils.checkpoint`` (non-reentrant)
where the reference wraps it in ``jax.checkpoint``: only the superblock's
input is kept, and backward runs its forward again; the remainder layers
are not wrapped, as in the reference.  Under checkpoint the first forward
runs with grad enabled, so the ``ssm_scan``, ``wkv`` and
``window_attention`` wrappers launch their training forwards (the
recurrences with checkpoints of the state) twice a step, once in the
forward and once in the recompute, and ``kernels.LAUNCHES`` counts both.
Remat changes no number: the recompute is the same arithmetic.

``ctx`` (``ShardCtx``, defined in ``models.params``; ``NULL_CTX`` does
nothing) lays the activations out on a device mesh at the reference's
constraint points: the stack's input and each layer's output (batch, seq,
embed), the queries (batch, seq, heads, head_dim), the logits (batch,
seq, vocab), each encoder layer's output, and a decode step's keys and
values (batch, kvseq, kv_heads, head_dim); the model axis K leads as an
unconstrained dim.  The weights are DTensors laid out by
``launch.shardings.param_shardings``; the forward and backward then run
on DTensors under ``ctx.scope()``, and the kernels on each rank's local
shards (``ctx.run_local``).

Layer kinds: ``global`` and ``local`` (sliding-window) attention and
``mamba``, each with a dense or an MoE FFN (``cfg.ffn_is_moe``), and
``rwkv`` (time-mix and channel-mix).  The MoE FFN's load-balancing loss is
per model: ``forward_train`` returns aux of shape (K,), each entry from
that model's own tokens, as the reference's loss vmapped over clients
gives.  The audio family's decoder layers add cross-attention to the
encoder's memory; the frontends are the reference's stubs (the batch
carries post-conv frame or patch embeddings, projected by
``frontend_proj``).

The decode cache is the reference's tree with the model axis leading
every leaf but ``pos`` (a 0-d int32 tensor: the tokens so far):
``stack/p<i>`` leaves (K, n_full, B, ...) and ``rem/r<j>`` leaves (K, B,
...).  An attention layer holds ``k`` and ``v`` (.., B, slots, KV, hd): a
local layer a ring of ``min(window, cache_len)`` slots, position p in slot
p % slots; a global layer its positions in order (past the last slot,
decode overwrites the last, as the reference does); an audio decoder layer
also ``xk`` / ``xv``, its cross-attention keys and values of the encoder's
memory.  A mamba layer holds ``conv`` (the last w-1 inputs) and ``h`` (fp32
state), an rwkv layer ``tm_prev``, ``h`` and ``cm_prev``.

Prefill and decode run under ``torch.no_grad``, so the scan and wkv kernels
launch their inference forwards.  ``forward_decode`` writes the cache's
tensors in place, as the reference donates the cache to its jitted step,
and returns them with the next ``pos``: a caller that needs the cache as
it was clones it first.  Decode keeps ``pos`` on the device (slots are
written by ``index_copy_``), so a step never waits for the card.

On a mesh the cache is a tree of DTensors (``pos`` replicated): prefill
makes it in the cache layout of its own rules (``CACHE_AXES``; each rank
allocates its shard) and every write lands in the writing rank's own
shards (``_fill_slots``, ``_write_slot``, ``_assign``): a ring's roll and
the headroom past the prompt included, a decode step's new key and value
on the rank holding its slot.  A decode step's attention reads each
rank's own slots (``attention.cached_attention``), and every leaf keeps
the placements it came with, the counterpart of the reference's pinned
``out_shardings``.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.layers import (apply_embed, apply_mlp, apply_norm,
                                       apply_unembed, init_embed, init_mlp,
                                       init_norm, matmul)
from repro_torch.models.params import (  # noqa: F401
    NULL_CTX, DTensor, Replicate, Shard, ShardCtx, local, local_shape, param,
    reshape, spec_for, spec_to_placements)

X_AXES = (None, "batch", "seq", "embed")      # (K, bs, S, d) activations

KINDS = ("global", "local", "mamba", "rwkv")
REMAT = ("none", "block", "full")     # block and full: one checkpoint a
#                                       superblock, as the reference's


def check_kinds(cfg: ModelConfig) -> None:
    """Raise for a layer kind the stack does not have."""
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
    """Wraps a factory, prepending a (n,) 'layers' dim (logical axis
    ``layers``) to every param.  A normal leaf's fan_in comes from the
    unstacked shape, as the reference's ``_Stacked`` computes it."""

    reads_axes = True

    def __init__(self, fac, n: int):
        self.fac, self.n = fac, n

    def param(self, shape, axes, init="normal", scale=1.0, in_dims=1,
              fan_in=None):
        if fan_in is None and init == "normal":
            fan_in = (int(np.prod(shape[:in_dims])) if len(shape) > 1
                      else max(shape[-1], 1))
        return param(self.fac, (self.n,) + tuple(shape),
                     ("layers",) + tuple(axes), init=init, scale=scale,
                     fan_in=fan_in)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(fac, cfg: ModelConfig, kind: str, pat_idx: int,
                cross: bool = False):
    if kind == "rwkv":        # no ffn: channel-mix is the rwkv layer's FFN
        return {"ln1": init_norm(fac, cfg), "ln2": init_norm(fac, cfg),
                "rwkv": rw.init_rwkv(fac, cfg)}
    if kind in ("global", "local"):
        mixer = {"attn": attn.init_attention(fac, cfg)}
        if cross:             # the audio decoder's cross-attention
            mixer.update(lnx=init_norm(fac, cfg),
                         xattn=attn.init_attention(fac, cfg))
    elif kind == "mamba":
        mixer = {"mamba": mb.init_mamba(fac, cfg)}
    else:                     # check_kinds has refused the others
        raise ValueError(kind)
    ffn = init_moe(fac, cfg) if cfg.ffn_is_moe(pat_idx) else init_mlp(fac,
                                                                       cfg)
    return {"ln1": init_norm(fac, cfg), **mixer, "ln2": init_norm(fac, cfg),
            "ffn": ffn}


def init_lm(fac, cfg: ModelConfig):
    """Full parameter tree of one LM (no model axis)."""
    check_kinds(cfg)
    plen, n_full, rem = pattern_info(cfg)
    cross = cfg.family == "audio"
    params: Dict[str, Any] = {"embed": init_embed(fac, cfg)}
    if cfg.frontend:
        params["frontend_proj"] = param(fac, (cfg.d_model, cfg.d_model),
                                        ("embed", "mlp"))
    stack: Dict[str, Any] = {}
    if n_full:
        sfac = _Stacked(fac, n_full)
        for pidx, kind in enumerate(cfg.layer_pattern):
            stack[f"p{pidx}"] = _init_block(sfac, cfg, kind, pidx, cross)
    params["stack"] = stack
    params["rem"] = {f"r{j}": _init_block(
        fac, cfg, cfg.layer_kinds[n_full * plen + j], j % plen, cross)
        for j in range(rem)}
    if cfg.family == "audio":
        enc = {}
        for j in range(cfg.encoder_layers):
            a = attn.init_attention(fac, cfg)
            enc[f"e{j}"] = {"ln1": init_norm(fac, cfg), "attn": a,
                            "ln2": init_norm(fac, cfg),
                            "ffn": init_mlp(fac, cfg)}
        params["encoder"] = enc
        params["enc_ln"] = init_norm(fac, cfg)
    params["final_ln"] = init_norm(fac, cfg)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, cache_len)
    return cache_len


# each cache leaf's logical axes, after its leading (K, n_full) or (K,)
# dims; ``h`` by the layer's kind (``launch.shardings`` reads the table)
KV_CACHE_AXES = ("batch", "kvseq", "kv_heads", "head_dim")
CACHE_AXES = {"k": KV_CACHE_AXES, "v": KV_CACHE_AXES, "xk": KV_CACHE_AXES,
              "xv": KV_CACHE_AXES, "conv": ("batch", None, "mlp"),
              "tm_prev": ("batch", "embed"), "cm_prev": ("batch", "embed")}
STATE_H_AXES = {"mamba": ("batch", "mlp", None),
                "rwkv": ("batch", "heads", None, None)}


def _cache_zeros(shape, axes, dtype, device, ctx=NULL_CTX):
    """A zero cache leaf; under ``ctx``'s mesh a DTensor laid out by
    ``spec_for`` of ``axes`` under the context's rules, each rank
    allocating its own shard only (the leading model axis unsharded)."""
    if ctx.mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
    spec = spec_for(shape, axes, ctx.rules, ctx.mesh)
    shard = torch.zeros(local_shape(shape, spec, ctx.mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(shard, ctx.mesh,
                              spec_to_placements(spec, ctx.mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype, lead: Tuple[int, ...] = (),
                     device=None, ctx=NULL_CTX):
    """One layer's zero cache, its leaves ``lead + (batch, ...)``."""
    kvh, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(name, *shape, dt=dtype):
        axes = STATE_H_AXES[kind] if name == "h" else CACHE_AXES[name]
        return _cache_zeros(lead + (batch,) + shape, axes, dt, device, ctx)
    if kind in ("global", "local"):
        s = _attn_cache_len(cfg, kind, cache_len)
        return {"k": zeros("k", s, kvh, hd), "v": zeros("v", s, kvh, hd)}
    if kind == "mamba":
        di = mb.d_inner(cfg)
        return {"conv": zeros("conv", cfg.ssm_conv_width - 1, di),
                "h": zeros("h", di, cfg.ssm_state_dim, dt=torch.float32)}
    if kind == "rwkv":
        h, n = rw.rwkv_heads(cfg)
        return {"tm_prev": zeros("tm_prev", cfg.d_model),
                "h": zeros("h", h, n, n, dt=torch.float32),
                "cm_prev": zeros("cm_prev", cfg.d_model)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, enc_len: int = 0, models: int = 1,
               device=None, ctx=NULL_CTX):
    """Decode cache for the whole stack of ``models`` models, on ``device``
    (the CUDA card unless the caller passes ``"cpu"``); under ``ctx``'s
    mesh its leaves are DTensors in the cache layout of the context's
    rules, ``pos`` replicated."""
    dev = resolve_device(device)
    plen, n_full, rem = pattern_info(cfg)

    def layer(kind, lead):
        lc = init_layer_cache(cfg, kind, batch, cache_len, dtype, lead, dev,
                              ctx)
        if cfg.family == "audio":
            for name in ("xk", "xv"):
                lc[name] = _cache_zeros(lead + (batch, enc_len,
                                                cfg.num_kv_heads,
                                                cfg.head_dim),
                                        KV_CACHE_AXES, dtype, dev, ctx)
        return lc
    stack = ({f"p{pidx}": layer(kind, (models, n_full))
              for pidx, kind in enumerate(cfg.layer_pattern)}
             if n_full else {})
    remc = {f"r{j}": layer(cfg.layer_kinds[n_full * plen + j], (models,))
            for j in range(rem)}
    return {"pos": _cache_zeros((), (), torch.int32, dev, ctx),
            "stack": stack, "rem": remc}


def _ring_positions(cache_slots: int, pos, window: int):
    """Original position of each ring-buffer slot given the current length
    ``pos`` (a 0-d int tensor).  Slot i holds the latest position p < pos
    with p % slots == i; -1 if empty or expired (p <= pos - window)."""
    idx = torch.arange(cache_slots, dtype=torch.int32, device=pos.device)
    last = pos - 1 - torch.remainder(pos - 1 - idx, cache_slots)
    valid = (last >= 0) & (last >= pos - window) & (pos > 0)
    return torch.where(valid, last, -1)


def _full_positions(cache_slots: int, pos):
    idx = torch.arange(cache_slots, dtype=torch.int32, device=pos.device)
    return torch.where(idx < pos, idx, -1)


# ---------------------------------------------------------------------------
# Cache writes: each rank writes its own shards
# ---------------------------------------------------------------------------

SLOT_DIM = 2          # of a layer's k / v / xk / xv leaf (K, B, slots, ..)


def _slots_whole(val, dst, ctx=NULL_CTX):
    """This rank's part of ``val`` (K, B, T, ...) in the layout of cache
    leaf ``dst`` with the slot dim whole: ``val`` itself off a mesh."""
    if not isinstance(dst, DTensor):
        return val
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == SLOT_DIM
               else p for p in dst.placements)
    return ctx.place(val, pl).to_local()


def _own_slots(dst, ctx=NULL_CTX):
    """(the local shard of cache leaf ``dst``, the global index of its
    first slot)."""
    if not isinstance(dst, DTensor):
        return dst, 0
    return dst.to_local(), ctx.shard_offset(dst, SLOT_DIM)


def _fill_slots(dst, val, slots: int, ctx=NULL_CTX):
    """Prefill's write of a layer's keys or values ``val`` (K, B, T, KV,
    hd) into cache leaf ``dst`` (K, B, slots, KV, hd): a local ring
    (slots < T) keeps the last ``slots`` positions, position p in slot
    p % slots; past T the slots stay zero (decode's headroom).  Each rank
    writes only the slots it holds."""
    total = val.shape[SLOT_DIM]
    v = _slots_whole(val, dst, ctx)
    if slots < total:
        v = torch.roll(v[:, :, -slots:], total % slots, SLOT_DIM)
    d, off = _own_slots(dst, ctx)
    hi = min(off + d.shape[SLOT_DIM], v.shape[SLOT_DIM])
    if hi > off:
        d[:, :, :hi - off].copy_(v[:, :, off:hi])


def _write_slot(dst, val, slot, ctx=NULL_CTX):
    """Decode's write of one token's keys or values ``val`` (K, B, 1, KV,
    hd) into slot ``slot`` (a 0-d device tensor) of cache leaf ``dst``.
    On a mesh only the rank holding the slot changes it: the others write
    their own first slot back as it was, so no rank waits for the card to
    learn where the slot lies, and nothing is communicated beyond laying
    ``val`` out like ``dst``."""
    slot = slot.reshape(1).long()
    if not isinstance(dst, DTensor):
        dst.index_copy_(SLOT_DIM, slot, val.to(dst.dtype))
        return
    v = _slots_whole(val, dst, ctx).to(dst.dtype)
    d, off = _own_slots(dst, ctx)
    i = slot - off
    own = (i >= 0) & (i < d.shape[SLOT_DIM])
    i = torch.where(own, i, torch.zeros_like(i))
    d.index_copy_(SLOT_DIM, i, torch.where(own, v,
                                           d.index_select(SLOT_DIM, i)))


def _assign(dst, val, ctx=NULL_CTX):
    """dst[...] = val in place: a DTensor leaf keeps its placements, each
    rank copying its shard of ``val`` laid out like ``dst``."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(ctx.place(val, dst.placements).to_local())
    else:
        dst.copy_(val)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_ffn(p, x, cfg: ModelConfig, is_moe: bool, ctx=NULL_CTX):
    """The dense or MoE FFN: x (K, bs, S, d) -> (y, aux (K,))."""
    if is_moe:
        y, aux = apply_moe(p, x, cfg, ctx=ctx)
        return y, aux.float()
    return apply_mlp(p, x, cfg), x.new_zeros((x.shape[0],),
                                             dtype=torch.float32)


def _unmasked(q, k, v):
    return attn.blockwise_attention(q, k, v, causal=False)


def _cross_attention(p, h, memory, cfg: ModelConfig, ctx=NULL_CTX):
    """The audio decoder's attention over the encoder's memory (K, bs, F,
    d), unmasked, without RoPE."""
    o = attn.sharded_attention(_unmasked, attn.project(h, p["wq"]),
                               attn.project(memory, p["wk"]),
                               attn.project(memory, p["wv"]), ctx,
                               lambda q, k, v, off: _unmasked(q, k, v))
    return attn.project_out(p, o, h.shape[0])


_RWKV_STATE = ("tm_prev", "h", "cm_prev")     # rwkv_block's state order


def _rwkv_norms(p, cfg: ModelConfig):
    """rwkv_block's ``norm_fn``: the layer's i-th pre-norm."""
    return lambda i, v: apply_norm(p[("ln1", "ln2")[i]], v, cfg)


def apply_block_train(p, x, cfg: ModelConfig, kind: str, pat_idx: int,
                      ctx=NULL_CTX, memory=None, positions=None,
                      want_kv: bool = False):
    """One layer in train or prefill mode: x (K, bs, S, d) -> (x, aux (K,),
    kv).  ``memory``: the encoder's output, read by cross-attention;
    ``positions``: RoPE positions (default 0..S-1).  With ``want_kv``, kv is
    an attention layer's (k, v) (K*bs, S, KV, hd) or a mamba / rwkv layer's
    final states by cache name; else None."""
    kv = None
    aux = x.new_zeros((x.shape[0],), dtype=torch.float32)
    if kind == "rwkv":
        km, bs, _, d = x.shape
        hh, nn = rw.rwkv_heads(cfg)
        prev = x.new_zeros((km, bs, d))
        h0 = torch.zeros((km, bs, hh, nn, nn), dtype=torch.float32,
                         device=x.device)
        x, state = rw.rwkv_block(p["rwkv"], x, cfg, (prev, h0, prev),
                                 _rwkv_norms(p, cfg), ctx=ctx)
        if want_kv:
            kv = dict(zip(_RWKV_STATE, state))
        return ctx.constrain(x, X_AXES), aux, kv
    h = apply_norm(p["ln1"], x, cfg)
    if kind in ("global", "local"):
        o, k, v = attn.attention_layer(p["attn"], h, cfg, kind,
                                       positions=positions, ctx=ctx)
        x = x + o
        if want_kv:
            kv = (k, v)
        if memory is not None:
            x = x + _cross_attention(p["xattn"], apply_norm(p["lnx"], x, cfg),
                                     memory, cfg, ctx)
    elif kind == "mamba":
        y, (conv, h_last) = mb.mamba_block(p["mamba"], h, cfg, ctx=ctx)
        x = x + y
        if want_kv:           # prefill: the final (conv, ssm) states
            kv = {"conv": conv, "h": h_last}
    else:                     # check_kinds has refused the others
        raise ValueError(kind)
    y, aux = _apply_ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg,
                        cfg.ffn_is_moe(pat_idx), ctx)
    return ctx.constrain(x + y, X_AXES), aux, kv


def apply_block_decode(p, x, cfg: ModelConfig, kind: str, pat_idx: int,
                       cache, pos, ctx=NULL_CTX):
    """One-token decode of one layer: x (K, B, 1, d); ``cache`` this layer's
    leaves (K, B, ...), written in place (on a mesh, each rank its own
    shards: the leaves keep their placements); ``pos`` the 0-d position of
    the token, a plain tensor on every rank.  Returns (x, cache)."""
    if kind == "rwkv":        # one token: rwkv_block takes time_mix_step
        x, state = rw.rwkv_block(p["rwkv"], x, cfg,
                                 tuple(cache[n] for n in _RWKV_STATE),
                                 _rwkv_norms(p, cfg), ctx=ctx)
        for name, val in zip(_RWKV_STATE, state):
            _assign(cache[name], val, ctx)
        return x, cache
    h = apply_norm(p["ln1"], x, cfg)
    if kind in ("global", "local"):
        km, bs = x.shape[:2]
        q, k, v = attn.project_qkv(p["attn"], h, cfg, pos.reshape(1, 1))
        slots = cache["k"].shape[2]
        if kind == "local" and cfg.sliding_window:
            slot = torch.remainder(pos, slots)
            kv_pos = _ring_positions(slots, pos + 1, cfg.sliding_window)
        else:
            slot = torch.clamp(pos, max=slots - 1)
            kv_pos = _full_positions(slots, pos + 1)
        for name, val in (("k", k), ("v", v)):
            _write_slot(cache[name], reshape(val, km, bs, *val.shape[1:]),
                        slot, ctx)
        o = attn.cached_attention(
            q, cache["k"], cache["v"], kv_pos, ctx,
            window=cfg.sliding_window if kind == "local" else 0)
        x = x + attn.project_out(p["attn"], o, km)
        if "xk" in cache:     # cross-attention against the cached memory
            qx = attn.project(apply_norm(p["lnx"], x, cfg), p["xattn"]["wq"])
            enc_pos = torch.arange(cache["xk"].shape[2], dtype=torch.int32,
                                   device=x.device)
            ox = attn.cached_attention(qx, cache["xk"], cache["xv"], enc_pos,
                                       ctx)
            x = x + attn.project_out(p["xattn"], ox, km)
    elif kind == "mamba":
        y, (conv, h_new) = mb.mamba_decode_step(p["mamba"], h, cfg,
                                                (cache["conv"], cache["h"]))
        _assign(cache["conv"], conv, ctx)
        _assign(cache["h"], h_new, ctx)
        x = x + y
    else:                     # check_kinds has refused the others
        raise ValueError(kind)
    y, _aux = _apply_ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg,
                         cfg.ffn_is_moe(pat_idx), ctx)
    return x + y, cache


# ---------------------------------------------------------------------------
# Full-stack forward
# ---------------------------------------------------------------------------

def _layers(params, cfg: ModelConfig):
    """Each layer in order as (parameters, kind, pattern index, cache key,
    layer): ``layer`` indexes the stacked cache's n_full axis, None for a
    remainder layer.  Each stacked leaf (K, n_full, ...) is split once."""
    plen, n_full, rem = pattern_info(cfg)
    split = {f"p{pidx}": tree_map(lambda v: v.unbind(1),
                                  params["stack"][f"p{pidx}"])
             for pidx in range(plen)} if n_full else {}
    for layer in range(n_full):
        for pidx, kind in enumerate(cfg.layer_pattern):
            yield (tree_map(lambda vs: vs[layer], split[f"p{pidx}"]), kind,
                   pidx, ("stack", f"p{pidx}"), layer)
    for j in range(rem):
        yield (params["rem"][f"r{j}"], cfg.layer_kinds[n_full * plen + j],
               j % plen, ("rem", f"r{j}"), None)


def _layer_cache(cache, key, layer: Optional[int]):
    """One layer's cache leaves (K, B, ...): views into the stacked leaves
    for a stacked layer, so writes land in the cache."""
    lc = cache[key[0]][key[1]]
    return lc if layer is None else {n: t[:, layer] for n, t in lc.items()}


def _frontend_prefix(params, cfg: ModelConfig, batch):
    """VLM patch prefix (projected), in the two operands' promoted dtype
    as the reference's ``@`` gives it."""
    if cfg.family == "vlm" and "patches" in batch:
        pt, w = batch["patches"], params["frontend_proj"]
        dt = torch.promote_types(pt.dtype, w.dtype)
        return matmul(pt.to(dt), w.to(dt))
    return None


def encode_audio(params, cfg: ModelConfig, frames, ctx=NULL_CTX):
    """Bidirectional encoder over the (stub) post-conv frame embeddings:
    frames (K, B, F, d) -> memory (K, B, F, d)."""
    x = matmul(frames, params["frontend_proj"])
    km = x.shape[0]
    for j in range(cfg.encoder_layers):
        p = params["encoder"][f"e{j}"]
        h = apply_norm(p["ln1"], x, cfg)
        pa = p["attn"]
        o = attn.sharded_attention(_unmasked, attn.project(h, pa["wq"]),
                                   attn.project(h, pa["wk"]),
                                   attn.project(h, pa["wv"]), ctx,
                                   lambda q, k, v, off: _unmasked(q, k, v))
        x = x + attn.project_out(pa, o, km)
        x = x + apply_mlp(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg)
        x = ctx.constrain(x, X_AXES)
    return apply_norm(params["enc_ln"], x, cfg)


def _inputs(params, cfg: ModelConfig, batch, ctx=NULL_CTX):
    """The stack's input: (x (K, B, S', d) with any patch prefix in front,
    laid out by ``ctx``, the encoder's memory or None, the prefix's
    length)."""
    x = apply_embed(params["embed"], batch["tokens"], cfg, ctx).to(
        getattr(torch, cfg.compute_dtype))
    memory = None
    if cfg.family == "audio":
        memory = encode_audio(params, cfg, batch["frames"].to(x.dtype), ctx)
    prefix = _frontend_prefix(params, cfg, batch)
    if prefix is None:
        return ctx.constrain(x, X_AXES), memory, 0
    x = torch.cat([prefix.to(x.dtype), x], dim=2)
    return ctx.constrain(x, X_AXES), memory, prefix.shape[2]


def _superblock(x, blocks, cfg: ModelConfig, memory, positions,
                ctx=NULL_CTX):
    """The layers of one superblock in turn: (x, their aux summed (K,))."""
    aux_sb = x.new_zeros((x.shape[0],), dtype=torch.float32)
    for p, kind, pidx in blocks:
        x, aux, _ = apply_block_train(p, x, cfg, kind, pidx, ctx,
                                      memory=memory, positions=positions)
        aux_sb = aux_sb + aux
    return x, aux_sb


def forward_train(params, cfg: ModelConfig, batch, remat: str = "none",
                  ctx=NULL_CTX):
    """Returns (logits (K, bs, S, V), aux_loss (K,)).  batch: tokens
    (K, bs, S) [+ patches (K, bs, P, d) | frames (K, bs, F, d)].
    ``remat`` "block" or "full" recomputes each superblock in backward
    (``torch.utils.checkpoint``); "none" keeps every activation."""
    check_kinds(cfg)
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}; expected one of {REMAT}")
    x, memory, n_prefix = _inputs(params, cfg, batch, ctx)
    positions = torch.arange(x.shape[2], dtype=torch.int32,
                             device=x.device)[None]
    aux_total = x.new_zeros((x.shape[0],), dtype=torch.float32)
    # consecutive layers of one superblock share their ``layer`` index;
    # the remainder layers (``layer`` None) run one at a time, unwrapped
    for layer, group in itertools.groupby(_layers(params, cfg),
                                          key=lambda t: t[4]):
        blocks = [(p, kind, pidx) for p, kind, pidx, _key, _l in group]
        if layer is None:
            for block in blocks:
                x, aux = _superblock(x, [block], cfg, memory, positions, ctx)
                aux_total = aux_total + aux
            continue
        if remat != "none":       # the forward draws no random numbers
            x, aux = checkpoint(_superblock, x, blocks, cfg, memory,
                                positions, ctx, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _superblock(x, blocks, cfg, memory, positions, ctx)
        aux_total = aux_total + aux
    x = apply_norm(params["final_ln"], x, cfg)
    if n_prefix:
        x = x[:, :, n_prefix:]
    logits = apply_unembed(params["embed"], x, cfg)
    return ctx.constrain(logits, (None, "batch", "seq", "vocab")), aux_total


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch, ctx=NULL_CTX,
                    max_len: Optional[int] = None):
    """Prefill: the full forward that also fills the decode cache.  Returns
    (last-token logits (K, B, 1, V), cache).  ``max_len`` sets the cache's
    length (at least the prefill's, the default), headroom for decode.
    Local layers keep the last window of their keys and values as a ring;
    mamba and rwkv layers store their final states."""
    check_kinds(cfg)
    x, memory, _n_prefix = _inputs(params, cfg, batch, ctx)
    km, bsz, total, _ = x.shape
    positions = torch.arange(total, dtype=torch.int32, device=x.device)[None]
    cache = init_cache(cfg, bsz, max(max_len or total, total), x.dtype,
                       memory.shape[2] if memory is not None else 0, km,
                       x.device, ctx)
    local(cache["pos"]).fill_(total)
    for p, kind, pidx, key, layer in _layers(params, cfg):
        x, _aux, kv = apply_block_train(p, x, cfg, kind, pidx, ctx,
                                        memory=memory, positions=positions,
                                        want_kv=True)
        lc = _layer_cache(cache, key, layer)
        if isinstance(kv, dict):       # mamba / rwkv final states
            for name, val in kv.items():
                _assign(lc[name], val, ctx)
        else:
            slots = lc["k"].shape[2]
            for name, val in zip(("k", "v"), kv):
                _fill_slots(lc[name], reshape(val, km, bsz, total,
                                              *val.shape[2:]), slots, ctx)
            if memory is not None:
                for name, w in (("xk", "wk"), ("xv", "wv")):
                    _assign(lc[name], reshape(attn.project(
                        memory, p["xattn"][w]), lc[name].shape), ctx)
    x = apply_norm(params["final_ln"], x, cfg)
    return apply_unembed(params["embed"], x[:, :, -1:], cfg), cache


@torch.no_grad()
def forward_decode(params, cfg: ModelConfig, tokens, cache, ctx=NULL_CTX):
    """One decode step.  tokens: (K, B, 1).  Returns (logits (K, B, 1, V),
    cache): the cache's tensors written in place, with the next ``pos``."""
    pos = cache["pos"]
    x = ctx.constrain(apply_embed(params["embed"], tokens, cfg, ctx).to(
        getattr(torch, cfg.compute_dtype)), X_AXES)
    for p, kind, pidx, key, layer in _layers(params, cfg):
        x, _ = apply_block_decode(p, x, cfg, kind, pidx,
                                  _layer_cache(cache, key, layer),
                                  local(pos), ctx)
    x = apply_norm(params["final_ln"], x, cfg)
    return apply_unembed(params["embed"], x, cfg), {
        "pos": pos + 1, "stack": cache["stack"], "rem": cache["rem"]}
