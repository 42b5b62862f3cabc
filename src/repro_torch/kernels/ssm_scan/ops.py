"""Wrapper for the selective-SSM scan kernels: CUDA tensors launch the
forward and backward kernels in ``csrc/ssm_scan.cu`` through a
``torch.autograd.Function``; CPU tensors run the plain loop in ``ref.py``
under autograd.

The JAX wrapper padded D to its 128-512 block and S to its chunk for the
TPU's tiling; the CUDA kernels mask ragged S, D and n themselves, so
nothing is padded here.  ``a`` may carry one matrix per group of sequences
((G, D, n), B % G == 0), which is how a stack of G client models, each with
its own ``a_log``, runs in one launch; its gradient is returned per group.

dt, b, c and x may be bfloat16 (all four alike), as the reference's
``mamba_impl="pallas"`` route hands the TPU kernel its compute-dtype
operands: the forward kernel widens them as it loads them and writes y in
float32, so the result is bit for bit the float32 call's on the widened
operands.  a and h0 are float32 (a bf16 one is widened here).  The
backward kernel is float32: bf16 operands saved for it are widened once,
and each gradient is returned in its operand's dtype.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

MAX_N = 16          # kMaxN in csrc/ssm_scan.cu


def _check(dt, b, c, x, a, h0) -> int:
    """Validate shapes, dtypes and layout; return the group count G."""
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and x {tuple(x.shape)} must "
                         f"both be (B, S, D)")
    bsz, s, d = dt.shape
    if b.dim() != 3 or b.shape[:2] != (bsz, s) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be (B={bsz}, S={s}, n)")
    n = b.shape[2]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"state size n={n} outside [1, {MAX_N}]")
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    if a.dim() not in (2, 3) or a3.shape[1:] != (d, n):
        raise ValueError(f"a {tuple(a.shape)} must be (D={d}, n={n}) or "
                         f"(G, {d}, {n})")
    g = a3.shape[0]
    if bsz % g:
        raise ValueError(f"B={bsz} sequences do not split into G={g} groups")
    if h0.shape != (bsz, d, n):
        raise ValueError(f"h0 {tuple(h0.shape)} must be ({bsz}, {d}, {n})")
    K.operand_dtype(dt=dt, b=b, c=c, x=x)
    for name, t in (("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("x", x), ("a", a),
                    ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return g


def _fwd(dt, b, c, x, a, h0, g: int, keep: bool):
    bsz, s, d = dt.shape
    n = b.shape[2]
    lib = K.load_library()
    bf16 = dt.dtype == torch.bfloat16
    y = torch.empty(dt.shape, dtype=torch.float32, device=dt.device)
    h_last = torch.empty_like(h0)
    ckpt = None
    if keep:
        steps = lib.repro_ssm_scan_ckpt_steps()
        ckpt = torch.empty((bsz, -(-s // steps), d, n), dtype=torch.float32,
                           device=dt.device)
    err = lib.repro_ssm_scan_fwd(
        dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        ckpt.data_ptr() if keep else None,
        bsz, s, d, n, g, int(bf16), K.stream_of(dt))
    K.check_launch(err, "ssm_scan")
    K.count_launch("ssm_scan", bf16)
    return y, h_last, ckpt


def _bwd(dt, b, c, x, a, ckpt, gy, ghl, g: int):
    bsz, s, d = dt.shape
    n = b.shape[2]
    lib = K.load_library()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((g, d, n), dtype=torch.float32, device=dt.device)
    dh0 = torch.empty((bsz, d, n), dtype=torch.float32, device=dt.device)
    work = torch.empty(lib.repro_ssm_scan_bwd_workspace(bsz, s, d, n),
                       dtype=torch.float32, device=dt.device)
    err = lib.repro_ssm_scan_bwd(
        dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
        ckpt.data_ptr(), gy.data_ptr(), ghl.data_ptr(), ddt.data_ptr(),
        db.data_ptr(), dc.data_ptr(), dx.data_ptr(), da.data_ptr(),
        dh0.data_ptr(), work.data_ptr(), bsz, s, d, n, g, K.stream_of(dt))
    K.check_launch(err, "ssm_scan_bwd")
    K.count_launch("ssm_scan_bwd")
    return ddt, db, dc, dx, da, dh0


class _SsmScan(torch.autograd.Function):
    """Forward kernel; in backward, the backward kernel from the forward's
    checkpoints of h."""

    @staticmethod
    def forward(ctx, dt, b, c, x, a, h0, g, keep):
        y, h_last, ckpt = _fwd(dt, b, c, x, a, h0, g, keep)
        ctx.save_for_backward(dt, b, c, x, a, ckpt)
        ctx.g = g
        return y, h_last

    @staticmethod
    def backward(ctx, gy, ghl):
        saved = ctx.saved_tensors
        dtypes = [t.dtype for t in saved[:4]]
        # the backward kernel is float32: widen bf16 operands once
        dt, b, c, x = (t.float() for t in saved[:4])
        a, ckpt = saved[4:]
        if ckpt is None:
            raise RuntimeError("ssm_scan backward without the forward's "
                               "checkpoints")
        gy = torch.zeros_like(dt) if gy is None else gy.contiguous()
        bsz, _, d = dt.shape
        ghl = (torch.zeros((bsz, d, b.shape[2]), dtype=torch.float32,
                           device=dt.device)
               if ghl is None else ghl.contiguous())
        ddt, db, dc, dx, da, dh0 = _bwd(dt, b, c, x, a, ckpt, gy, ghl, ctx.g)
        ddt, db, dc, dx = (grad.to(dtype) for grad, dtype in
                           zip((ddt, db, dc, dx), dtypes))
        return ddt, db, dc, dx, da.reshape(a.shape), dh0, None, None


def ssm_scan(dt, b, c, x, a, h0):
    """Fused selective-SSM scan, differentiable.  dt, x: (B,S,D); b, c:
    (B,S,n) with n <= 16, these four float32 or all bfloat16; a: (D,n) or
    (G,D,n) with B % G == 0; h0: (B,D,n).  Returns (y (B,S,D), h_last
    (B,D,n)), float32."""
    if not K.on_cuda(dt, b, c, x, a, h0):
        return ssm_scan_ref(dt, b, c, x, a, h0)
    a, h0 = (t.float() if t.dtype == torch.bfloat16 else t for t in (a, h0))
    g = _check(dt, b, c, x, a, h0)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, b, c, x, a, h0))
    return _SsmScan.apply(dt, b, c, x, a, h0, g, keep)
