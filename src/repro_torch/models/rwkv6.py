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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.models.layers import matmul, per_model

LORA_DIM = 64


def rwkv_heads(cfg: ModelConfig):
    n = cfg.rwkv_head_dim
    assert cfg.d_model % n == 0
    return cfg.d_model // n, n


def init_rwkv(fac, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        # time-mix
        "mu": fac.param((5, d), init="uniform", scale=1.0),
        "w_base": fac.param((d,), init="constant", scale=0.5),
        "w_lora_a": fac.param((d, LORA_DIM), scale=0.1),
        "w_lora_b": fac.param((LORA_DIM, d), scale=0.1),
        "u": fac.param((d,), init="uniform", scale=0.5),
        "wr": fac.param((d, d)),
        "wk": fac.param((d, d)),
        "wv": fac.param((d, d)),
        "wg": fac.param((d, d)),
        "wo": fac.param((d, d)),
        "ln_x_scale": fac.param((d,), init="ones"),
        "ln_x_bias": fac.param((d,), init="zeros"),
        # channel-mix
        "mu_ck": fac.param((d,), init="uniform", scale=1.0),
        "mu_cr": fac.param((d,), init="uniform", scale=1.0),
        "ck": fac.param((d, f)),
        "cv": fac.param((f, d)),
        "cr": fac.param((d, d)),
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
    yn = ((y32 - mu) * torch.rsqrt(var + 1e-5)).flatten(-2)
    return yn * per_model(p["ln_x_scale"].float(), yn) \
        + per_model(p["ln_x_bias"].float(), yn)


def time_mix(p, x, cfg: ModelConfig, state):
    """x: (K, bs, S, d).  state = (shift_prev (K, bs, d), h (K, bs, H, N,
    N)).  Returns (y, (x[..., -1, :], h_last))."""
    h, n = rwkv_heads(cfg)
    km, bs, s, d = x.shape
    prev, hstate = state
    xs = _shift(x, prev)
    mu = p["mu"].unbind(1)                       # five (K, d) leaves
    xr, xk, xv, xg, xw = (_mix(x, xs, m) for m in mu)

    def heads(t):
        return t.float().reshape(km * bs, s, h, n).contiguous()
    r = heads(matmul(xr, p["wr"]))
    k = heads(matmul(xk, p["wk"])) * (n ** -0.5)
    v = heads(matmul(xv, p["wv"]))
    g = F.silu(matmul(xg, p["wg"]))
    lw = heads(_log_decay(p, xw))
    u = p["u"].float().reshape(km, h, n).contiguous()
    h0 = hstate.float().reshape(km * bs, h, n, n).contiguous()
    y, h_new = wkv(r, k, v, lw, u, h0)
    y = _headnorm(p, y.reshape(km, bs, s, h, n), cfg).to(x.dtype) * g
    return matmul(y, p["wo"]), (x[..., -1, :],
                                h_new.reshape(km, bs, h, n, n))


def time_mix_step(p, x, cfg: ModelConfig, state):
    """Decode: x (K, bs, 1, d).  state = (shift_prev (K, bs, d), h (K, bs,
    H, N, N)).  Returns (y, (x[..., 0, :], h_new))."""
    h, n = rwkv_heads(cfg)
    km, bs = x.shape[:2]
    prev, hstate = state
    xs = prev.unsqueeze(-2)
    xr, xk, xv, xg, xw = (_mix(x, xs, m) for m in p["mu"].unbind(1))

    def heads(t):
        return t.float().reshape(km, bs, h, n)
    r = heads(matmul(xr, p["wr"]))
    k = heads(matmul(xk, p["wk"])) * (n ** -0.5)
    v = heads(matmul(xv, p["wv"]))
    g = F.silu(matmul(xg, p["wg"]))
    w = heads(torch.exp(_log_decay(p, xw)))
    u = p["u"].float().reshape(km, 1, h, n)
    # y = r (S + diag(u) k^T v)
    y = torch.einsum("kbhn,kbhnm->kbhm", r, hstate) \
        + (r * u * k).sum(-1, keepdim=True) * v
    h_new = w[..., None] * hstate + torch.einsum("kbhn,kbhm->kbhnm", k, v)
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


def rwkv_block(p, x, cfg: ModelConfig, state, norm_fn):
    """Full RWKV layer: ln -> time-mix -> residual -> ln -> channel-mix;
    a one-token x takes the decode step.  state = (tm_prev, h, cm_prev);
    ``norm_fn(i, x)`` applies the stack's i-th pre-norm."""
    tm_prev, hstate, cm_prev = state
    mix = time_mix_step if x.shape[-2] == 1 else time_mix
    a, (tm_prev2, h2) = mix(p, norm_fn(0, x), cfg, (tm_prev, hstate))
    x = x + a
    bmix, cm_prev2 = channel_mix(p, norm_fn(1, x), cfg, cm_prev)
    x = x + bmix
    return x, (tm_prev2, h2, cm_prev2)
