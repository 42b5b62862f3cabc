"""GQA attention for training (``repro.models.attention``): the blockwise
(flash-style) path with an online softmax, its causal block-skipping form
and the sliding-window path with structural skipping.

q: (B, S, H, hd); k, v: (B, S, KV, hd), with query head h reading kv head
h // (H // KV).  A stack of K models folds its model axis into B: these
functions hold no parameters.  All of them are plain PyTorch with the
reference's arithmetic, so the CPU and the card run the same operations;
the hand-written sliding-window kernel (``kernels.window_attn``) takes the
place of ``local_blockwise_attention`` in the model's local layers on the
card, as the reference's Pallas kernel is a drop-in for it.

Not ported: ``decode_attention`` and ``attention_block`` (serving with the
caches) and cross-attention (the audio family).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


def init_attention(fac, cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": fac.param((d, h, hd)),
        "wk": fac.param((d, kv, hd)),
        "wv": fac.param((d, kv, hd)),
        "wo": fac.param((h, hd, d), in_dims=2),
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
    qb = q.reshape(b, nq, bq, nkv, g, hd).float()
    kb = k.reshape(b, nk, bkv, nkv, hd).float()
    vb = v.reshape(b, nk, bkv, nkv, hd).float()
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
    out = torch.cat(outs, dim=1).reshape(b, nq * bq, h, hd)
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
    qb = q.reshape(b, nq, bq, nkv, g, hd).float()
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
    out = torch.cat(outs, dim=1).reshape(b, nq * bq, h, hd)
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
