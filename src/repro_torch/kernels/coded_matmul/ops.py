"""Wrappers for the coded matmul kernels: CUDA tensors launch the kernel in
``csrc/coded_matmul.cu``, CPU tensors run the plain version in ``ref.py``.

The JAX wrappers padded to (8, 128) multiples for the TPU's tiling; the CUDA
kernel masks ragged edges itself, so nothing is padded here.

Each operand may be float32 or bfloat16, as the TPU kernels take them: the
CUDA kernels widen bf16 coefficients and w as they read them (no fp32 copy
in device memory) and accumulate in fp32; the plain versions widen first,
which gives the same products."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import kernels as K
from repro_torch.kernels.coded_matmul.ref import (coded_encode_decode_ref,
                                                  coded_matmul_ref,
                                                  coded_matmul_rounds_ref)

_OUT_DTYPES = (torch.float32, torch.bfloat16)

# load_width -> the C interface's ``vec`` flag
_VEC_FLAG = {4: 1, 2: 2, 1: 0}


def _aligned(t: torch.Tensor, n: int) -> bool:
    return t.data_ptr() % (n * t.element_size()) == 0


def load_width(p: int, w: torch.Tensor, out: torch.Tensor) -> int:
    """Columns a thread of ``coded_matmul_kernel`` loads and stores at once:
    4 when every row of w and out starts on 16 bytes (P % 4 == 0 and both
    buffers 16-byte aligned), 2 when P is even and both buffers are aligned
    to two of their elements (the rows then start on 8 bytes of fp32, 4 of
    bf16), else 1.  Every width gives the same bits."""
    if p % 4 == 0 and K.aligned16(w, out):
        return 4
    if p % 2 == 0 and _aligned(w, 2) and _aligned(out, 2):
        return 2
    return 1


def _launch(coeff: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
            width: Optional[int] = None) -> torch.Tensor:
    """coeff (C,S), w (G,S,P) on one CUDA device -> (G,C,P); ``width``
    overrides ``load_width`` (a narrower width is always valid: the
    chip check times the routes against each other)."""
    c, s = coeff.shape
    g, s2, p = w.shape
    if s != s2:
        raise ValueError(f"coeff {tuple(coeff.shape)} does not match w "
                         f"{tuple(w.shape)}")
    for name, t in (("coeff", coeff), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    out = torch.empty((g, c, p), dtype=out_dtype, device=w.device)
    width = load_width(p, w, out) if width is None else width
    err = K.load_library().repro_coded_matmul(
        coeff.data_ptr(), w.data_ptr(), out.data_ptr(), g, c, s, p,
        int(out_dtype == torch.bfloat16), _VEC_FLAG[width], K.is_bf16(coeff),
        K.is_bf16(w), K.stream_of(w))
    K.check_launch(err, "coded_matmul")
    return out


def _bf16(*operands: torch.Tensor) -> bool:
    return any(t.dtype == torch.bfloat16 for t in operands)


def coded_matmul(coeff: torch.Tensor, w: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(C,S) @ (S,P) -> (C,P), fp32 accumulate; ``out_dtype`` is float32
    (default) or bfloat16 storage for the result."""
    if not K.on_cuda(coeff, w):
        return coded_matmul_ref(coeff, w, out_dtype)
    if w.dim() != 2 or coeff.dim() != 2:
        raise ValueError("coded_matmul takes coeff (C,S) and w (S,P)")
    out = _launch(coeff, w.unsqueeze(0), out_dtype or torch.float32)[0]
    K.count_launch("coded_matmul", _bf16(coeff, w))
    return out


def coded_matmul_rounds(coeff: torch.Tensor, w: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """(C,S) @ (G,S,P) -> (G,C,P): the all-rounds encode, read straight from
    the stacked history with no concatenate copy."""
    if not K.on_cuda(coeff, w):
        return coded_matmul_rounds_ref(coeff, w, out_dtype)
    if w.dim() != 3 or coeff.dim() != 2:
        raise ValueError("coded_matmul_rounds takes coeff (C,S) and "
                         "w (G,S,P)")
    out = _launch(coeff, w, out_dtype or torch.float32)
    K.count_launch("coded_matmul_rounds", _bf16(coeff, w))
    return out


def coded_encode_decode(enc: torch.Tensor, dec: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The fused round trip dec (S,C) @ (enc (C,S) @ w (S,P)) -> (S,P), fp32,
    with the (C,P) coded intermediate never in device memory; each operand
    float32 or bfloat16."""
    if not K.on_cuda(enc, dec, w):
        return coded_encode_decode_ref(enc, dec, w)
    if enc.dim() != 2 or dec.dim() != 2 or w.dim() != 2:
        raise ValueError("coded_encode_decode takes enc (C,S), dec (S,C) "
                         "and w (S,P)")
    c, s = enc.shape
    if dec.shape != (s, c) or w.shape[0] != s:
        raise ValueError(f"enc {tuple(enc.shape)}, dec {tuple(dec.shape)} "
                         f"and w {tuple(w.shape)} do not agree")
    for name, t in (("enc", enc), ("dec", dec), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = w.shape[1]
    out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    vec = p % 4 == 0 and K.aligned16(w, out)
    err = K.load_library().repro_encode_decode(
        enc.data_ptr(), dec.data_ptr(), w.data_ptr(), out.data_ptr(), c, s, p,
        int(vec), K.is_bf16(enc), K.is_bf16(dec), K.is_bf16(w),
        K.stream_of(w))
    K.check_launch(err, "encode_decode")
    K.count_launch("encode_decode", _bf16(enc, dec, w))
    return out
