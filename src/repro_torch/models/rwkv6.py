"""RWKV-6 "Finch" block on a stack of K models (``repro.models.rwkv6``).

Recurrence (per head, key-dim N x value-dim N state S):
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ,   w_t = exp(-exp(base + lora(x)))

The recurrence runs through the ``wkv`` kernel for both ``rwkv_impl``
values: the K models' sequences go into one launch, with each model's own
``u`` as one group of the kernel's grouped ``u``; prefill carries its
final state out.  The reference's chunk-parallel XLA form (``wkv_scan``)
is not ported.  Decode (``time_mix_step``, which ``rwkv_block`` picks for
a one-token sequence, as the reference's does) is the O(N^2) single-step
recurrence in plain PyTorch, as the reference's is plain jnp.

Under a ``ShardCtx`` with a mesh, the recurrence runs on each rank's
local shards: sequences over ``data``, heads over ``model``; it is per
head, so no collective runs inside it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.layers import matmul, per_model
from repro_torch.models.params import NULL_CTX, param, reshape

LORA_DIM = 64
SEQ_AXES = ("batch", None, "heads", None)        # r, k, v, lw (B, S, H, N)
# the recurrence's operands: r, k, v, lw, u (K, H, N), h0 (B, H, N, N)
WKV_AXES = (SEQ_AXES,) * 4 + ((None, "heads", None),
                              ("batch", "heads", None, None))


def _wkv_local(r, k, v, lw, u, h0):
    return wkv(*(t.contiguous() for t in (r, k, v, lw, u, h0)))


# decode's operands: r, k, v, w, u (K, B, H, N) (u's B is 1), state (K, B,
# H, N, N)
STEP_AXES = ((None, "batch", "heads", None),) * 5 + (
    (None, "batch", "heads", None, None),)


def _step_local(r, k, v, w, u, hstate):
    """One token of the recurrence: y = r (S + diag(u) k^T v), and the
    state decayed by w plus k^T v.  Independent per sequence and head, so
    on a mesh it runs on each rank's shards (DTensor's einsum would flatten
    the split batch and head dims together, which torch 2.11's view rule
    refuses)."""
    y = torch.einsum("kbhn,kbhnm->kbhm", r, hstate) \
        + (r * u * k).sum(-1, keepdim=True) * v
    h_new = w[..., None] * hstate + torch.einsum("kbhn,kbhm->kbhnm", k, v)
    return y, h_new


def rwkv_heads(cfg: ModelConfig):
    n = cfg.rwkv_head_dim
    assert cfg.d_model % n == 0
    return cfg.d_model // n, n


def init_rwkv(fac, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        # time-mix
        "mu": param(fac, (5, d), (None, "embed"), init="uniform",
                    scale=1.0),
        "w_base": param(fac, (d,), ("embed",), init="constant",
                        scale=0.5),
        "w_lora_a": param(fac, (d, LORA_DIM), ("embed", None), scale=0.1),
        "w_lora_b": param(fac, (LORA_DIM, d), (None, "embed"), scale=0.1),
        "u": param(fac, (d,), ("embed",), init="uniform", scale=0.5),
        "wr": param(fac, (d, d), ("embed", "heads_flat")),
        "wk": param(fac, (d, d), ("embed", "heads_flat")),
        "wv": param(fac, (d, d), ("embed", "heads_flat")),
        "wg": param(fac, (d, d), ("embed", "heads_flat")),
        "wo": param(fac, (d, d), ("heads_flat", "embed")),
        "ln_x_scale": param(fac, (d,), ("embed",), init="ones"),
        "ln_x_bias": param(fac, (d,), ("embed",), init="zeros"),
        # channel-mix
        "mu_ck": param(fac, (d,), ("embed",), init="uniform",
                       scale=1.0),
        "mu_cr": param(fac, (d,), ("embed",), init="uniform",
                       scale=1.0),
        "ck": param(fac, (d, f), ("embed", "mlp")),
        "cv": param(fac, (f, d), ("mlp", "embed")),
        "cr": param(fac, (d, d), ("embed", "heads_flat")),
    }


def _shift(x, prev):
    """Token shift: x_{t-1} along the sequence axis, with ``prev``
    (K, bs, d) as x_0's predecessor."""
    return torch.cat([prev.unsqueeze(-2), x[..., :-1, :]], dim=-2)


def _mix(x, xs, mu):
    """x + mu * (xs - x) with a (K, d) leaf ``mu``."""
    return x + per_model(mu.to(x.dtype), x) * (xs - x)


def _log_decay(p, xw):
    """-exp(base + lora(x)) — the per-channel log decay, <= 0."""
    lora = matmul(torch.tanh(matmul(xw, p["w_lora_a"])), p["w_lora_b"])
    z = per_model(p["w_base"].float(), lora) + lora.float()
    return -torch.exp(torch.clamp(z, -10.0, 3.0))


def _headnorm(p, y, cfg: ModelConfig):
    """Per-head LayerNorm (RWKV GroupNorm with H groups): y (K, bs, S, H, N)
    -> (K, bs, S, H*N)."""
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = torch.square(y32 - mu).mean(-1, keepdim=True)
    yn = (y32 - mu) * torch.rsqrt(var + 1e-5)
    yn = reshape(yn, *yn.shape[:-2], -1)
    return yn * per_model(p["ln_x_scale"].float(), yn) \
        + per_model(p["ln_x_bias"].float(), yn)


def time_mix(p, x, cfg: ModelConfig, state, ctx=NULL_CTX):
    """x: (K, bs, S, d).  state = (shift_prev (K, bs, d), h (K, bs, H, N,
    N)).  Returns (y, (x[..., -1, :], h_last))."""
    h, n = rwkv_heads(cfg)
    km, bs, s, d = x.shape
    prev, hstate = state
    xs = _shift(x, prev)
    mu = p["mu"].unbind(1)                       # five (K, d) leaves
    xr, xk, xv, xg, xw = (_mix(x, xs, m) for m in mu)

    def heads(t):
        return reshape(t.float(), km * bs, s, h, n).contiguous()
    r = heads(matmul(xr, p["wr"]))
    k = heads(matmul(xk, p["wk"])) * (n ** -0.5)
    v = heads(matmul(xv, p["wv"]))
    g = F.silu(matmul(xg, p["wg"]))
    lw = heads(_log_decay(p, xw))
    u = reshape(p["u"].float(), km, h, n).contiguous()
    h0 = reshape(hstate.float(), km * bs, h, n, n).contiguous()
    y, h_new = ctx.run_local(_wkv_local, (r, k, v, lw, u, h0), WKV_AXES,
                             outs=(0, 5))
    y = _headnorm(p, reshape(y, km, bs, s, h, n), cfg).to(x.dtype) * g
    return matmul(y, p["wo"]), (x[..., -1, :],
                                reshape(h_new, km, bs, h, n, n))


def time_mix_step(p, x, cfg: ModelConfig, state, ctx=NULL_CTX):
    """Decode: x (K, bs, 1, d).  state = (shift_prev (K, bs, d), h (K, bs,
    H, N, N)).  Returns (y, (x[..., 0, :], h_new)); on a mesh h_new keeps
    h's placements."""
    h, n = rwkv_heads(cfg)
    km, bs = x.shape[:2]
    prev, hstate = state
    xs = prev.unsqueeze(-2)
    xr, xk, xv, xg, xw = (_mix(x, xs, m) for m in p["mu"].unbind(1))

    def heads(t):
        return reshape(t.float(), km, bs, h, n)
    r = heads(matmul(xr, p["wr"]))
    k = heads(matmul(xk, p["wk"])) * (n ** -0.5)
    v = heads(matmul(xv, p["wv"]))
    g = F.silu(matmul(xg, p["wg"]))
    w = heads(torch.exp(_log_decay(p, xw)))
    u = reshape(p["u"].float(), km, 1, h, n)
    y, h_new = ctx.run_local(_step_local, (r, k, v, w, u, hstate),
                             STEP_AXES, outs=(0, 5))
    y = _headnorm(p, y.unsqueeze(2), cfg).to(x.dtype) * g
    return matmul(y, p["wo"]), (x[..., 0, :], h_new)


def channel_mix(p, x, cfg: ModelConfig, prev):
    """RWKV channel-mix (the FFN).  Returns (y, x[..., -1, :])."""
    xs = _shift(x, prev)
    xk = _mix(x, xs, p["mu_ck"])
    xr = _mix(x, xs, p["mu_cr"])
    kk = torch.square(F.relu(matmul(xk, p["ck"])))
    return torch.sigmoid(matmul(xr, p["cr"])) * matmul(kk, p["cv"]), \
        x[..., -1, :]


def rwkv_block(p, x, cfg: ModelConfig, state, norm_fn, ctx=NULL_CTX):
    """Full RWKV layer: ln -> time-mix -> residual -> ln -> channel-mix;
    a one-token x takes the decode step.  state = (tm_prev, h, cm_prev);
    ``norm_fn(i, x)`` applies the stack's i-th pre-norm."""
    tm_prev, hstate, cm_prev = state
    if x.shape[-2] == 1:
        a, (tm_prev2, h2) = time_mix_step(p, norm_fn(0, x), cfg,
                                          (tm_prev, hstate), ctx)
    else:
        a, (tm_prev2, h2) = time_mix(p, norm_fn(0, x), cfg,
                                     (tm_prev, hstate), ctx)
    x = x + a
    bmix, cm_prev2 = channel_mix(p, norm_fn(1, x), cfg, cm_prev)
    x = x + bmix
    return x, (tm_prev2, h2, cm_prev2)
