"""Mamba selective-SSM block (jamba's recurrent layer) on a stack of K
models (``repro.models.mamba``).

The recurrence runs through the ``ssm_scan`` kernel for both
``mamba_impl`` values: the K models' sequences go into one launch, with
each model's own ``a = -exp(a_log)`` as one group of the kernel's grouped
``a``.  The kernel gets dt, B, C and x in the compute dtype (bf16 on a bf16
config), as the reference's ``mamba_impl="pallas"`` route hands its TPU
kernel, and widens them as it loads them.  The scan keeps its state in
fp32.  ``ssm_chunk_dtype="bfloat16"`` is the reference's option to store
its chunked XLA path's (B, c, di, n) chunk tensors in bf16, to halve their
HBM traffic; the kernel never writes those tensors to device memory, so
the port accepts the option and keeps its fp32 registers (the result is
the float32 option's, within the reference's own 0.05 of it).  Prefill
carries the final conv and scan states out (``mamba_block``, the scan's
h0 in and h_last out); decode
(``mamba_decode_step``) is one recurrence step in plain PyTorch, as the
reference's is plain jnp outside any kernel.

Under a ``ShardCtx`` with a mesh, the scan runs on each rank's local
shards: sequences over ``data``, channels (``mlp``) over ``model``; the
recurrence is per channel, so no collective runs inside it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.models.layers import matmul, per_model
from repro_torch.models.params import NULL_CTX, param, reshape, zero_pad

# the scan's operands: dt, B, C, x (K*bs, S, .), a (K, di, n), h0
SCAN_AXES = (("batch", None, "mlp"), ("batch", None, None),
             ("batch", None, None), ("batch", None, "mlp"),
             (None, "mlp", None), ("batch", "mlp", None))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def init_mamba(fac, cfg: ModelConfig):
    d, di, n = cfg.d_model, d_inner(cfg), cfg.ssm_state_dim
    r, w = dt_rank(cfg), cfg.ssm_conv_width
    return {
        "in_proj": param(fac, (d, 2 * di), ("embed", "mlp")),
        "conv_w": param(fac, (w, di), (None, "mlp"), scale=0.5),
        "conv_b": param(fac, (di,), ("mlp",), init="zeros"),
        "x_proj": param(fac, (di, r + 2 * n), ("mlp", None)),
        "dt_proj": param(fac, (r, di), (None, "mlp")),
        "dt_bias": param(fac, (di,), ("mlp",), init="constant",
                         scale=-2.0),
        # log(-A): A = -exp(a_log)
        "a_log": param(fac, (di, n), ("mlp", None), init="uniform",
                       scale=1.5),
        "d_skip": param(fac, (di,), ("mlp",), init="ones"),
        "out_proj": param(fac, (di, d), ("mlp", "embed")),
    }


def _conv1d_causal(x, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv of each model's sequences: x (K, ..., S, di);
    conv_w (K, w, di); conv_b (K, di); ``conv_state`` (K, ..., w-1, di),
    the inputs before x (decode continuity), zeros when None.  A sum over
    the w taps.  Returns (y, the last w-1 inputs)."""
    taps = conv_w.unbind(1)
    w, s = len(taps), x.shape[-2]
    xp = (zero_pad(x, -2, before=w - 1) if conv_state is None
          else torch.cat([conv_state, x], dim=-2))
    y = sum(xp[..., i:i + s, :] * per_model(taps[i], x) for i in range(w))
    return y + per_model(conv_b, x), xp[..., s:, :]


def _ssm_params(p, x, cfg: ModelConfig):
    """x: (K, ..., T, di) -> dt (K, ..., T, di), B_ and C_ (K, ..., T, n)."""
    n, r = cfg.ssm_state_dim, dt_rank(cfg)
    xdb = matmul(x, p["x_proj"])
    dt_lo, b_, c_ = torch.split(xdb, [r, n, n], dim=-1)
    dt = F.softplus(matmul(dt_lo, p["dt_proj"])
                    + per_model(p["dt_bias"].to(xdb.dtype), xdb))
    return dt, b_, c_


def _scan_local(dt, b_, c_, x, a, h0):
    return ssm_scan(*(t.contiguous() for t in (dt, b_, c_, x, a, h0)))


def mamba_scan(p, x, cfg: ModelConfig, h0=None, ctx=NULL_CTX):
    """Selective scan over post-conv activations x (K, bs, S, di).
    Returns (y (K, bs, S, di), h_last (K, bs, di, n))."""
    if cfg.ssm_chunk_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"ssm_chunk_dtype={cfg.ssm_chunk_dtype!r}: "
                         f"float32 or bfloat16")
    k, bs, s, di = x.shape
    n = cfg.ssm_state_dim
    a = -torch.exp(p["a_log"].float())                       # (K, di, n)
    dt, b_, c_ = _ssm_params(p, x, cfg)
    if h0 is None:
        h0 = torch.zeros((k * bs, di, n), dtype=torch.float32,
                         device=x.device)
    else:
        h0 = reshape(h0, k * bs, di, n).float().contiguous()

    def seqs(t):        # in the compute dtype: the kernel widens bf16
        return reshape(t, k * bs, s, t.shape[-1]).contiguous()
    y, h_last = ctx.run_local(_scan_local, (seqs(dt), seqs(b_), seqs(c_),
                                            seqs(x), a, h0),
                              SCAN_AXES, outs=(0, 5))
    y = reshape(y, k, bs, s, di) + x.float() * per_model(
        p["d_skip"].float(), x)
    return y.to(x.dtype), reshape(h_last, k, bs, di, n)


def mamba_block(p, x, cfg: ModelConfig, state=None, ctx=NULL_CTX):
    """Full block (training and prefill form). x: (K, bs, S, d).  state =
    (conv_state (K, bs, w-1, di), h (K, bs, di, n)) or None (zeros).
    Returns (y, (conv_state, h_last))."""
    conv_state, h0 = state if state is not None else (None, None)
    xin, z = torch.chunk(matmul(x, p["in_proj"]), 2, dim=-1)
    xc, new_conv = _conv1d_causal(xin, p["conv_w"], p["conv_b"], conv_state)
    y, h_last = mamba_scan(p, F.silu(xc), cfg, h0=h0, ctx=ctx)
    y = y * F.silu(z)
    return matmul(y, p["out_proj"]), (new_conv, h_last)


def mamba_decode_step(p, x, cfg: ModelConfig, state):
    """One token: x (K, bs, 1, d); state = (conv_state (K, bs, w-1, di),
    h (K, bs, di, n) fp32).  Returns (y, (conv_state, h))."""
    conv_state, h = state
    xin, z = torch.chunk(matmul(x, p["in_proj"]), 2, dim=-1)
    xc, new_conv = _conv1d_causal(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)                                          # (K, bs, 1, di)
    dt, b_, c_ = _ssm_params(p, xc, cfg)
    a = -torch.exp(p["a_log"].float())                       # (K, di, n)
    x32 = xc[..., 0, :].float()                              # (K, bs, di)
    dt32 = dt[..., 0, :].float()
    abar = torch.exp(dt32[..., None] * a[:, None])           # (K, bs, di, n)
    bu = dt32[..., None] * b_[..., 0, :].float()[..., None, :] \
        * x32[..., None]
    h_new = abar * h + bu
    y = torch.einsum("kbn,kbdn->kbd", c_[..., 0, :].float(), h_new)
    y = y + x32 * per_model(p["d_skip"].float(), x32)
    y = y[..., None, :].to(x.dtype) * F.silu(z)
    return matmul(y, p["out_proj"]), (new_conv, h_new)
