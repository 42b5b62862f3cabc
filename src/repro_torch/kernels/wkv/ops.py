"""Wrapper for the WKV kernels: CUDA tensors launch the forward and
backward kernels in ``csrc/wkv.cu`` through a ``torch.autograd.Function``;
CPU tensors run the plain loop in ``ref.py`` under autograd.

The JAX wrapper folded (B, H) into its grid axis, broadcast ``u`` per head
and padded S to its chunk for the TPU's tiling; the CUDA kernels read r, k,
v, lw in their (B, S, H, N) layout and mask ragged S and N themselves, so
nothing is copied or padded here.  ``u`` may carry one vector per group of
sequences ((G, H, N), B % G == 0), which is how a stack of G client models,
each with its own ``u``, runs in one launch; its gradient is returned per
group.

r, k, v and lw may be bfloat16 (all four alike), as the TPU kernel takes
them: the forward kernel widens them as it loads them and writes y in
float32, so the result is bit for bit the float32 call's on the widened
operands.  u and h0 are float32 (a bf16 one is widened here).  The
backward kernel is float32: bf16 operands saved for it are widened once,
and each gradient is returned in its operand's dtype.  (The rwkv6 model
hands the kernel float32, as the reference's model does.)
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.wkv.ref import wkv_ref

MAX_N = 64          # kMaxN in csrc/wkv.cu


def _check(r, k, v, lw, u, h0) -> int:
    """Validate shapes, dtypes and layout; return the group count G."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and lw {tuple(lw.shape)} must all "
                         f"be (B, S, H, N)")
    bsz, _, h, n = r.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"head size N={n} outside [1, {MAX_N}]")
    u3 = u if u.dim() == 3 else u.unsqueeze(0)
    if u.dim() not in (2, 3) or u3.shape[1:] != (h, n):
        raise ValueError(f"u {tuple(u.shape)} must be (H={h}, N={n}) or "
                         f"(G, {h}, {n})")
    g = u3.shape[0]
    if bsz % g:
        raise ValueError(f"B={bsz} sequences do not split into G={g} groups")
    if h0.shape != (bsz, h, n, n):
        raise ValueError(f"h0 {tuple(h0.shape)} must be ({bsz}, {h}, {n}, "
                         f"{n})")
    K.operand_dtype(r=r, k=k, v=v, lw=lw)
    for name, t in (("u", u), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
                    ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return g


def _fwd(r, k, v, lw, u, h0, g: int, keep: bool):
    bsz, s, h, n = r.shape
    lib = K.load_library()
    bf16 = r.dtype == torch.bfloat16
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    h_last = torch.empty_like(h0)
    ckpt = None
    if keep:
        steps = lib.repro_wkv_ckpt_steps()
        ckpt = torch.empty((bsz, h, -(-s // steps), n, n),
                           dtype=torch.float32, device=r.device)
    err = lib.repro_wkv_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        ckpt.data_ptr() if keep else None, bsz, s, h, n, g, int(bf16),
        K.stream_of(r))
    K.check_launch(err, "wkv")
    K.count_launch("wkv", bf16)
    return y, h_last, ckpt


def _bwd(r, k, v, lw, u, ckpt, gy, ghl, g: int):
    bsz, s, h, n = r.shape
    lib = K.load_library()
    dr, dk = torch.empty_like(r), torch.empty_like(k)
    dv, dlw = torch.empty_like(v), torch.empty_like(lw)
    du = torch.empty((g, h, n), dtype=torch.float32, device=r.device)
    dh0 = torch.empty((bsz, h, n, n), dtype=torch.float32, device=r.device)
    work = torch.empty(bsz * h * n, dtype=torch.float32, device=r.device)
    err = lib.repro_wkv_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), ckpt.data_ptr(), gy.data_ptr(), ghl.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du.data_ptr(), dh0.data_ptr(), work.data_ptr(), bsz, s, h, n, g,
        K.stream_of(r))
    K.check_launch(err, "wkv_bwd")
    K.count_launch("wkv_bwd")
    return dr, dk, dv, dlw, du, dh0


class _Wkv(torch.autograd.Function):
    """Forward kernel; in backward, the backward kernel from the forward's
    checkpoints of the state."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, h0, g, keep):
        y, h_last, ckpt = _fwd(r, k, v, lw, u, h0, g, keep)
        ctx.save_for_backward(r, k, v, lw, u, ckpt)
        ctx.g = g
        return y, h_last

    @staticmethod
    def backward(ctx, gy, ghl):
        saved = ctx.saved_tensors
        dtypes = [t.dtype for t in saved[:4]]
        # the backward kernel is float32: widen bf16 operands once
        r, k, v, lw = (t.float() for t in saved[:4])
        u, ckpt = saved[4:]
        if ckpt is None:
            raise RuntimeError("wkv backward without the forward's "
                               "checkpoints")
        gy = torch.zeros_like(r) if gy is None else gy.contiguous()
        bsz, _, h, n = r.shape
        ghl = (torch.zeros((bsz, h, n, n), dtype=torch.float32,
                           device=r.device)
               if ghl is None else ghl.contiguous())
        dr, dk, dv, dlw, du, dh0 = _bwd(r, k, v, lw, u, ckpt, gy, ghl, ctx.g)
        dr, dk, dv, dlw = (grad.to(dtype) for grad, dtype in
                           zip((dr, dk, dv, dlw), dtypes))
        return dr, dk, dv, dlw, du.reshape(u.shape), dh0, None, None


def wkv(r, k, v, lw, u, h0):
    """Fused RWKV-6 WKV recurrence, differentiable.  r, k, v, lw:
    (B,S,H,N) with N <= 64, float32 or all bfloat16; u: (H,N) or (G,H,N)
    with B % G == 0; h0: (B,H,N,N).  Returns (y (B,S,H,N), h_last
    (B,H,N,N)), float32."""
    if not K.on_cuda(r, k, v, lw, u, h0):
        return wkv_ref(r, k, v, lw, u, h0)
    u, h0 = (t.float() if t.dtype == torch.bfloat16 else t for t in (u, h0))
    g = _check(r, k, v, lw, u, h0)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, lw, u, h0))
    return _Wkv.apply(r, k, v, lw, u, h0, g, keep)
