"""GQA attention (``repro.models.attention``): the blockwise
(flash-style) training and prefill path with an online softmax, its causal
block-skipping form, the sliding-window path with structural skipping and
the direct single-token decode path against a cache.

q: (B, S, H, hd); k, v: (B, S, KV, hd), with query head h reading kv head
h // (H // KV).  A stack of K models folds its model axis into B: these
functions hold no parameters.  All of them are plain PyTorch with the
reference's arithmetic, so the CPU and the card run the same operations;
the hand-written sliding-window kernel (``kernels.window_attn``) takes the
place of ``local_blockwise_attention`` in the model's local layers on the
card, as the reference's Pallas kernel is a drop-in for it.
``project_qkv`` and ``project_out`` are the projections of a layer of K
models (leaves (K, d, heads, hd)); ``attention_layer`` is the whole layer
with the k and v it computed, ``attention_block`` its output alone.

Under a ``ShardCtx`` with a mesh, ``attention_layer`` lays the queries out
as (batch, seq, heads, head_dim), the reference's constraint, and runs the
attention (the window kernel or the blockwise forms) on each rank's local
shards (``sharded_attention``): batch over ``data``, heads over ``model``.
A rank whose query heads are split while the kv heads are not (kv heads
that do not divide the mesh dim) reads the kv heads of its own query
groups.  Where the rules split the sequence (sequence-parallel prefill)
each rank attends with its own query rows, at their offset, against the
keys and values gathered along the sequence.  ``cached_attention`` is a
decode step's attention against a layer's cache as it lies on the mesh:
where the slots are split, each rank's partial softmax over its own
slots, merged over the mesh dims that split them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.window_attn.ops import window_attention
from repro_torch.models.layers import apply_rope, matmul
from repro_torch.models.params import (NULL_CTX, DTensor, Replicate, Shard,
                                       local, local_map, param, reshape)

NEG_INF = -1e30
KV_KERNEL_AXES = ("batch", None, "kv_heads", None)  # K and V on a mesh
Q_ROW_AXES = ("batch", "seq", "heads", None)        # sequence-parallel rows


def init_attention(fac, cfg: ModelConfig):
    """q/k/v/o projections; the decoder's cross-attention draws the same
    shapes, kept under the block's ``xattn`` key."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": param(fac, (d, h, hd), ("embed", "heads", "head_dim")),
        "wk": param(fac, (d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": param(fac, (d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": param(fac, (h, hd, d), ("heads", "head_dim", "embed"),
                    in_dims=2),
    }


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(q,), (kv,) positions -> (q, kv) additive bias; kv_pos < 0 marks
    padded slots."""
    ok = (kv_pos[None, :] >= 0).expand(q_pos.shape[0], -1)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if window and window > 0:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _pad_seq(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad axis 1 of (B, S, heads, hd)."""
    if not (before or after):
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, 0, before, after))


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        kv_positions: Optional[torch.Tensor] = None,
                        block_q: int = 512, block_kv: int = 512
                        ) -> torch.Tensor:
    """Flash-style attention with an online softmax over (block_q x
    block_kv) score tiles; every tile is computed and masked (the local
    path skips structurally).  Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = h // nkv
    scale = hd ** -0.5
    dev = q.device

    bq = min(block_q, sq)
    bkv = min(block_kv, skv)
    pq = (-sq) % bq
    pkv = (-skv) % bkv
    q_pos = q_offset + torch.arange(sq + pq, dtype=torch.int32, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(skv, dtype=torch.int32, device=dev)
    kv_pos = torch.cat([kv_positions, torch.full(
        (pkv,), -1, dtype=torch.int32, device=dev)])
    q, k, v = _pad_seq(q, 0, pq), _pad_seq(k, 0, pkv), _pad_seq(v, 0, pkv)

    nq, nk = (sq + pq) // bq, (skv + pkv) // bkv
    qb = reshape(q, b, nq, bq, nkv, g, hd).float()
    kb = reshape(k, b, nk, bkv, nkv, hd).float()
    vb = reshape(v, b, nk, bkv, nkv, hd).float()
    outs = []
    for i in range(nq):
        qcur, qp = qb[:, i], q_pos[i * bq:(i + 1) * bq]
        m = torch.full((b, nkv, g, bq), NEG_INF, device=dev)
        l = torch.zeros((b, nkv, g, bq), device=dev)
        acc = torch.zeros((b, nkv, g, bq, hd), device=dev)
        for j in range(nk):
            kp = kv_pos[j * bkv:(j + 1) * bkv]
            s = torch.einsum("bqkgd,bskd->bkgqs", qcur, kb[:, j]) * scale
            s = s + _mask_bias(qp, kp, causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb[:, j])
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)      # (B,KV,G,bq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))               # (B,bq,KV,G,hd)
    out = reshape(torch.cat(outs, dim=1), b, nq * bq, h, hd)
    return out[:, :sq].to(q.dtype)


def local_blockwise_attention(q, k, v, *, window: int, q_offset: int = 0,
                              block_q: int = 512) -> torch.Tensor:
    """Sliding-window attention with structural skipping: each query block
    attends to a kv span of window + block_q slots, so the work is
    O(S (window + block_q)).  Self-attention with aligned positions."""
    b, s, h, hd = q.shape
    nkv = k.shape[2]
    g = h // nkv
    scale = hd ** -0.5
    dev = q.device
    bq = min(block_q, s)
    pq = (-s) % bq
    q = _pad_seq(q, 0, pq)
    nq = (s + pq) // bq
    span = ((window + bq + bq - 1) // bq) * bq   # a multiple of bq
    # left-pad kv by span so every slice is in bounds; padded slots are -1
    k_pad = _pad_seq(k, span, pq).float()
    v_pad = _pad_seq(v, span, pq).float()
    kv_pos_pad = torch.cat([
        torch.full((span,), -1, dtype=torch.int32, device=dev),
        torch.arange(s + pq, dtype=torch.int32, device=dev)])
    qb = reshape(q, b, nq, bq, nkv, g, hd).float()
    outs = []
    for i in range(nq):
        start = i * bq           # kv span [start - span, start + bq)
        kcur = k_pad[:, start:start + span + bq]
        vcur = v_pad[:, start:start + span + bq]
        kp = kv_pos_pad[start:start + span + bq]
        qp = q_offset + start + torch.arange(bq, dtype=torch.int32,
                                             device=dev)
        s_ = torch.einsum("bqkgd,bskd->bkgqs", qb[:, i], kcur) * scale
        ok = ((kp[None, :] >= 0) & (kp[None, :] <= qp[:, None])
              & (kp[None, :] > qp[:, None] - window))
        s_ = s_ + torch.where(ok, 0.0, NEG_INF).float()
        p = torch.softmax(s_, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vcur))
    out = reshape(torch.cat(outs, dim=1), b, nq * bq, h, hd)
    return out[:, :s].to(q.dtype)


def causal_skip_attention(q, k, v, *, window: int = 0, block_q: int = 0,
                          block_kv: int = 512) -> torch.Tensor:
    """Causal attention with structural block skipping: query block i
    reads only kv blocks 0..i (the true triangle).  Ragged shapes fall
    back to ``blockwise_attention``."""
    b, s, h, hd = q.shape
    if block_q == 0:
        block_q = max(s // 16, 512)         # at most 16 query blocks
    bq = min(block_q, s)
    if s % bq or s % block_kv:
        return blockwise_attention(q, k, v, causal=True, window=window)
    outs = []
    for i in range(s // bq):
        end = (i + 1) * bq
        outs.append(blockwise_attention(
            q[:, i * bq:end], k[:, :end], v[:, :end], causal=True,
            window=window, q_offset=i * bq, block_q=bq, block_kv=block_kv))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, kv_positions, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, hd) against a cache (B, S, KV, hd).
    ``kv_positions`` (S,) or (B, S) int: the original position of each
    cache slot, -1 for an empty one, so a ring-buffer (window) cache, whose
    slot order is not position order, works too; the token being generated
    attends to every filled slot (``window`` is the reference's argument and
    masks nothing: the ring holds only the window).  Returns (B, 1, H, hd)
    in q's dtype."""
    b, sq, h, hd = q.shape
    nkv = k_cache.shape[2]
    qg = reshape(q, b, sq, nkv, h // nkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k_cache.float()) * hd ** -0.5
    if kv_positions.dim() == 1:
        kv_positions = kv_positions[None].expand(b, -1)
    bias = torch.where(kv_positions >= 0, 0.0, NEG_INF)     # (B, S)
    p = torch.softmax(s + bias[:, None, None, None, :], dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return reshape(out, b, sq, h, hd).to(q.dtype)


def _decode_merged(q, k, v, kv_positions, groups) -> torch.Tensor:
    """``decode_attention`` of q against this rank's slots of a cache
    whose slots are split over the mesh dims ``groups`` ((mesh, dim)
    pairs): each rank's scores, their maximum all-reduced, then each
    rank's sum of exponentials and its weighted values, all-reduced
    together, and the quotient.  An empty slot scores ``NEG_INF``, a
    finite number, so a rank whose slots are all empty adds exp(NEG_INF -
    m) = 0 to both sums (or, when no slot anywhere is filled, the
    uniform weights ``softmax`` gives)."""
    from torch.distributed import _functional_collectives as funcol
    b, sq, h, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, h // nkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if kv_positions.dim() == 1:
        kv_positions = kv_positions[None].expand(b, -1)
    s = s + torch.where(kv_positions >= 0, 0.0, NEG_INF)[:, None, None,
                                                          None, :]
    m = s.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    p = torch.exp(s - m)
    lo = torch.cat([p.sum(-1, keepdim=True),
                    torch.einsum("bkgqs,bskd->bkgqd", p, v.float())], -1)
    for g in groups:
        lo = funcol.all_reduce(lo, "sum", g)
    out = lo[..., 1:] / lo[..., :1]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def cached_attention(q, k_cache, v_cache, kv_positions, ctx=NULL_CTX, *,
                     window: int = 0) -> torch.Tensor:
    """A decode step's attention of q (K*B, 1, H, hd) against a layer's
    cache leaves (K, B, S, KV, hd).  Off a mesh, or on one whose cache
    leaves are plain tensors, ``decode_attention`` of the flattened cache.
    On a mesh each rank reads its own shard of the cache as it lies:
    batch and kv heads as the cache splits them (q laid out to match:
    its heads replicated where the cache's slots take the mesh dim), and
    its own slots, with ``kv_positions`` (S,) or (K*B, S) sliced to them.
    Where the slots are split, ``_decode_merged`` combines the ranks'
    partial softmaxes over the mesh dims that split them; where they are
    not, each rank runs ``decode_attention`` itself.  A head_dim split of
    the cache is gathered for the product."""
    if not isinstance(k_cache, DTensor):
        return decode_attention(q, k_cache.flatten(0, 1),
                                v_cache.flatten(0, 1), kv_positions,
                                window=window)
    mesh = ctx.mesh
    km, b, s_all, _, hd = k_cache.shape
    h = q.shape[2]
    cpl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 4 else p
                for p in k_cache.placements)
    k, v = ctx.place(k_cache, cpl), ctx.place(v_cache, cpl)
    # cache dims (K, B, S, KV, hd) -> q5's (K, B, 1, H, hd): batch and heads
    qpl = tuple(p if isinstance(p, Shard) and p.dim in (1, 3)
                else Replicate() for p in cpl)
    q5 = ctx.place(reshape(q, km, b, 1, h, hd), qpl)
    groups = [(mesh, i) for i, p in enumerate(cpl)
              if isinstance(p, Shard) and p.dim == 2]
    kl = k.to_local()
    s0, b0 = ctx.shard_offset(k, 2), ctx.shard_offset(k, 1)
    pos = local(kv_positions)
    if pos.dim() == 2:            # per row: this rank's rows
        pos = pos.reshape(km, b, s_all)[:, b0:b0 + kl.shape[1]].flatten(0, 1)
    pos = pos[..., s0:s0 + kl.shape[2]]

    def attend(ql, kl_, vl):
        qf, kf, vf = ql.flatten(0, 1), kl_.flatten(0, 1), vl.flatten(0, 1)
        o = (_decode_merged(qf, kf, vf, pos, groups) if groups else
             decode_attention(qf, kf, vf, pos, window=window))
        return o.reshape(ql.shape)
    o5 = local_map(attend, out_placements=(qpl,),
                   in_placements=(qpl, cpl, cpl),
                   device_mesh=mesh)(q5, k, v)
    return reshape(o5, km * b, 1, h, hd)


def project(x, w) -> torch.Tensor:
    """x (K, bs, S, d) @ w (K, d, heads, hd) -> (K*bs, S, heads, hd): the
    model axis folded into the batch."""
    km, bs, s, d = x.shape
    return reshape(matmul(x, reshape(w, km, d, -1)), km * bs, s,
                   *w.shape[2:])


def project_qkv(p, x, cfg: ModelConfig, positions):
    """q, k (RoPE at ``positions``, broadcast against (K*bs, S)) and v of a
    layer of K models: x (K, bs, S, d) -> (K*bs, S, heads, hd) each."""
    q = apply_rope(project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(project(x, p["wk"]), positions, cfg.rope_theta)
    return q, k, project(x, p["wv"])


def project_out(p, o, km: int) -> torch.Tensor:
    """o (K*bs, S, H, hd) @ wo (K, H, hd, d) -> (K, bs, S, d)."""
    kb, s, h, hd = o.shape
    return reshape(matmul(reshape(o, km, kb // km * s, h * hd),
                          reshape(p["wo"], km, h * hd, -1)),
                      km, kb // km, s, -1)


def sharded_attention(fn, q, k, v, ctx=NULL_CTX, rows_fn=None):
    """``fn(q, k, v)`` (an attention over (B, S, H, hd) queries and (B, S',
    KV, hd) keys and values, independent per sequence and head) under
    ``ctx``: batch and heads laid out by the context's rules (head_dim
    whole), ``fn`` on each rank's shards.  Query head h reads kv head h //
    (H // KV); where q's heads are split over the mesh and k's are not,
    each rank slices the kv heads of its own groups, and their gradient
    is a partial sum over the ranks that split q.

    Where the rules split the sequence (sequence-parallel prefill), the
    queries stay split: each rank gathers the keys and values along the
    sequence and runs ``rows_fn(q, k, v, q_offset)`` on its own query
    rows, ``q_offset`` the global position of its first (the blockwise
    forms' argument); a call whose sequence the rules split needs
    ``rows_fn``."""
    if ctx.mesh is None:
        return fn(q, k, v)
    q = ctx.constrain(q, Q_ROW_AXES)
    k = ctx.constrain(k, KV_KERNEL_AXES)
    rows = any(isinstance(p, Shard) and p.dim == 1 for p in q.placements)
    if rows and rows_fn is None:
        raise ValueError("the rules split the sequence: pass rows_fn")
    q_off = ctx.shard_offset(q, 1) if rows else 0
    h, kvh = q.shape[2], k.shape[2]
    hl, kl = q.to_local().shape[2], k.to_local().shape[2]
    lo, n = 0, kl
    if kl * h != kvh * hl:            # q's heads split, k's not
        g = h // kvh
        if hl % g and g % hl:
            raise ValueError(f"{hl} local query heads straddle GQA groups "
                             f"of {g}")
        lo, n = ctx.shard_offset(q, 2) // g, max(hl // g, 1)

    def local_fn(ql, kl_, vl):
        kl_, vl = kl_[:, :, lo:lo + n], vl[:, :, lo:lo + n]
        return rows_fn(ql, kl_, vl, q_off) if rows else fn(ql, kl_, vl)
    return ctx.run_local(local_fn, (q, k, v),
                         (Q_ROW_AXES, KV_KERNEL_AXES, KV_KERNEL_AXES),
                         outs=(0,))


def attention_layer(p, x, cfg: ModelConfig, kind: str, *, q_offset: int = 0,
                    positions: Optional[torch.Tensor] = None, ctx=NULL_CTX):
    """A whole attention layer for train / prefill on a stack of K models
    (q/k/v projections, RoPE, attention, output projection): x (K, bs, S,
    d) -> (out (K, bs, S, d), k, v), k and v (K*bs, S, KV, hd) as the cache
    stores them.  A local layer longer than its window runs the
    ``window_attention`` kernel in fp32, the reference's local arithmetic,
    and casts back, when its queries and keys share positions (``q_offset``
    0); with an offset, ``local_blockwise_attention``'s masks, which shift
    the queries alone, are what the reference computes."""
    km, bs, s, _ = x.shape
    if positions is None:
        positions = q_offset + torch.arange(s, dtype=torch.int32,
                                            device=x.device)[None]
    q, k, v = project_qkv(p, x, cfg, positions)
    q = ctx.constrain(q, ("batch", "seq", "heads", "head_dim"))
    win = cfg.sliding_window if kind == "local" else 0

    def rows(a, b, c, off):       # query rows from ``off`` on: masked full
        return blockwise_attention(a, b, c, causal=True, window=win,
                                   q_offset=q_offset + off,
                                   block_q=cfg.attn_block_q or s)
    if win and s > win and not q_offset:
        o = sharded_attention(lambda a, b, c: window_attention(a, b, c, win),
                              q.float(), k.float(), v.float(), ctx,
                              rows).to(q.dtype)
    elif win and s > win:
        o = sharded_attention(lambda a, b, c: local_blockwise_attention(
            a, b, c, window=win, q_offset=q_offset), q, k, v, ctx, rows)
    elif cfg.attn_block_skip and not q_offset:
        o = sharded_attention(lambda a, b, c: causal_skip_attention(
            a, b, c, window=win), q, k, v, ctx, rows)
    else:
        o = sharded_attention(lambda a, b, c: rows(a, b, c, 0), q, k, v, ctx,
                              rows)
    return project_out(p, o, km), k, v


def attention_block(p, x, cfg: ModelConfig, *, kind: str = "global",
                    q_offset: int = 0,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``attention_layer``'s output alone: x (K, bs, S, d) -> (K, bs, S,
    d)."""
    return attention_layer(p, x, cfg, kind, q_offset=q_offset,
                           positions=positions)[0]
