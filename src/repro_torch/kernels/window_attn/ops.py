"""Wrapper for the sliding-window attention kernels: CUDA tensors launch the
forward and backward kernels in ``csrc/window_attn.cu`` through a
``torch.autograd.Function``; CPU tensors run the dense masked softmax in
``ref.py`` under autograd.

The JAX wrapper expanded the GQA heads with ``repeat``, transposed to
(B*H, S, hd) and padded S to its block and hd to 128 for the TPU's tiling;
the CUDA kernels read q, k and v in the model's (B, S, heads, hd) layout
through their strides, map query head h to kv head h // (H // KV) and mask
ragged S and hd themselves, so nothing is copied or padded here.

q, k and v may be bfloat16 (all three alike), as the TPU kernel takes
them: bf16 operands take one of the forward's two bf16 routes, which
compute what the TPU kernel computes at bf16 (bf16 products with fp32
accumulation, P rounded to bf16 before P V, the softmax in fp32) and
return bf16.  ``bf16_route`` picks wgmma and TMA
(``csrc/window_attn_tma.cu``) where TMA can address the operands and the
head dim is one its boxes tile (64 or 128), else mma.sync
(``wattn_fwd_bf16_kernel`` in ``csrc/window_attn.cu``).  The
backward for bf16 operands widens the saved q, k, v, O and dO and runs the
float32 kernels (the TPU kernel had no backward); each gradient comes back
in its operand's dtype.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.window_attn.ref import window_attention_ref

MAX_HD = 128        # kMaxHd in csrc/window_attn.cu


def _check(q, k, v, window: int) -> None:
    """Validate shapes, dtypes, layout and the window."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, S, H, hd) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} both "
                         f"(B, S, KV, hd)")
    bsz, s, h, hd = q.shape
    if k.shape[:2] != (bsz, s) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} must be ({bsz}, {s}, KV, {hd})")
    if h % k.shape[2]:
        raise ValueError(f"H={h} query heads do not split over KV="
                         f"{k.shape[2]} kv heads")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"head dim hd={hd} outside [1, {MAX_HD}]")
    if int(window) < 1:
        raise ValueError(f"window={window} must be at least 1")
    K.operand_dtype(q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


TMA_HD = (64, 128)      # head dims the wgmma route's 64-column boxes tile


def bf16_route(q, k, v) -> str:
    """The bf16 forward's route for these operands: ``"tma"`` (wgmma and
    TMA) when the head dim is 64 or 128, H % KV == 0, q, k and v start on 16
    bytes and every stride but the head dim's is a positive multiple of 8
    elements (TMA's global strides are multiples of 16 bytes; a dim of
    extent 1 is never stepped, so its stride does not count), else
    ``"mma_sync"``."""
    hd = q.shape[3]
    if hd not in TMA_HD or q.shape[2] % k.shape[2]:
        return "mma_sync"
    for t in (q, k, v):
        if t.data_ptr() % 16:
            return "mma_sync"
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            if n > 1 and (st <= 0 or st % 8 or st >= 1 << 39):
                return "mma_sync"
    return "tma"


def _fwd(q, k, v, window: int, route=None):
    """O and lse by the forward kernel; ``route`` overrides ``bf16_route``
    for bf16 operands (``"mma_sync"`` takes any; the chip check times the
    two routes against each other)."""
    bsz, s, h, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty((bsz, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((bsz, h, s), dtype=torch.float32, device=q.device)
    lib = K.load_library()
    if not bf16:
        launch = lib.repro_window_attn_fwd
    elif (route or bf16_route(q, k, v)) == "tma":
        launch = lib.repro_window_attn_fwd_bf16_tma
    else:
        launch = lib.repro_window_attn_fwd_bf16
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bsz, s, h, k.shape[2], hd, window, hd ** -0.5,
        *_strides(q, k, v), K.stream_of(q))
    K.check_launch(err, "window_attention")
    K.count_launch("window_attention", bf16)
    return o, lse


def _bwd(q, k, v, o, lse, do, window: int):
    bsz, s, h, hd = q.shape
    dq = torch.empty_like(o)
    dk = torch.empty((bsz, s, k.shape[2], hd), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty_like(lse)
    err = K.load_library().repro_window_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), bsz, s, h, k.shape[2], hd, window,
        hd ** -0.5, *_strides(q, k, v), K.stream_of(q))
    K.check_launch(err, "window_attention_bwd")
    K.count_launch("window_attention_bwd")
    return dq, dk, dv


class _WindowAttention(torch.autograd.Function):
    """Forward kernel (O and the row log-sum-exp); in backward, the
    backward kernels, recomputing P from q, k and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = _fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dtypes = [t.dtype for t in (q, k, v)]
        # the backward kernels are float32: widen bf16 operands once
        q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.window)
        return (*(g.to(dt) for g, dt in zip((dq, dk, dv), dtypes)), None)


def window_attention(q, k, v, window: int):
    """Causal sliding-window attention, differentiable.  q: (B, S, H, hd),
    k, v: (B, S, KV, hd) with H % KV == 0 and hd <= 128, all float32 or all
    bfloat16, head dim contiguous.  Query i attends keys j with i - window
    < j <= i.  Returns (B, S, H, hd) in q's dtype."""
    if not K.on_cuda(q, k, v):
        return window_attention_ref(q, k, v, window)
    _check(q, k, v, window)
    return _WindowAttention.apply(q, k, v, int(window))
