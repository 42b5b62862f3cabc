"""Shared layers on a stack of K models: norms, gated MLP, embeddings,
RoPE (``repro.models.layers``).

Every parameter leaf carries a leading model axis (K, ...) and every
activation is (K, ..., d): model k is applied to activations[k], which is
the reference's layer under ``vmap`` over the client models.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import NULL_CTX, param, reshape

ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    """Pad vocab to a multiple of 512, as the reference does."""
    return ((vocab + multiple - 1) // multiple) * multiple


def per_model(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (K, d) leaf shaped to broadcast against activations (K, ..., d)."""
    return v.reshape(v.shape[0], *(1,) * (x.dim() - 2), v.shape[-1])


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, ..., a) @ (K, a, b) -> (K, ..., b): one batched product."""
    k = x.shape[0]
    out = torch.bmm(reshape(x, k, -1, x.shape[-1]), w)
    return reshape(out, *x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(fac, cfg: ModelConfig):
    if cfg.norm_type == "nonparametric":
        return {}
    return {"scale": param(fac, (cfg.d_model,), ("embed",),
                           init="ones")}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """Scale-only layernorm or rmsnorm, computed in fp32."""
    x32 = x.float()
    if cfg.norm_type in ("layernorm", "nonparametric"):
        mu = x32.mean(-1, keepdim=True)
        var = torch.square(x32 - mu).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
    else:  # rmsnorm
        var = torch.square(x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
    if p:
        y = y * per_model(p["scale"].float(), y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def init_mlp(fac, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    return {
        "wi_gate": param(fac, (cfg.d_model, d_ff), ("embed", "mlp")),
        "wi_up": param(fac, (cfg.d_model, d_ff), ("embed", "mlp")),
        "wo": param(fac, (d_ff, cfg.d_model), ("mlp", "embed")),
    }


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = ACTS[cfg.act](matmul(x, p["wi_gate"])) * matmul(x, p["wi_up"])
    return matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(fac, cfg: ModelConfig):
    v = pad_vocab(cfg.vocab_size)
    p = {"table": param(fac, (v, cfg.d_model), ("vocab", "embed"),
                        scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = param(fac, (cfg.d_model, v), ("embed", "vocab"))
    return p


def apply_embed(p, tokens: torch.Tensor, cfg: ModelConfig,
                ctx=NULL_CTX) -> torch.Tensor:
    """tokens (K, ...) int -> (K, ..., d): model k's table rows.  Under a
    mesh the table is gathered whole first (a row lookup along a sharded
    vocab is not one that DTensor shards)."""
    table = ctx.constrain(p["table"], (None, None, "embed"))
    k, v = table.shape[:2]
    base = torch.arange(k, device=tokens.device) * v
    idx = tokens.long() + base.reshape(k, *(1,) * (tokens.dim() - 1))
    return F.embedding(idx, reshape(table, k * v, table.shape[-1]))


def apply_unembed(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    v = pad_vocab(cfg.vocab_size)
    if cfg.tie_embeddings:
        logits = matmul(x, p["table"].transpose(1, 2))
    else:
        logits = matmul(x, p["unembed"])
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    # the padded vocab entries never win
    pad = torch.arange(v, device=x.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e9)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    t = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (t / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves rotation in fp32.  x: (..., seq, heads, head_dim);
    positions: (..., seq), broadcast against x's leading dims."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
