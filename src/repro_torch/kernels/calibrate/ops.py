"""Wrapper for the fused calibration kernel: CUDA tensors launch the kernel
in ``csrc/calibrate.cu``, CPU tensors run the plain version in ``ref.py``."""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.calibrate.ref import calibrate_update_ref


def calibrate_update(w: torch.Tensor, deltas: torch.Tensor,
                     coeffs: torch.Tensor) -> torch.Tensor:
    """w: (P,), deltas: (M,P), coeffs: (M,) -> (P,) = w + coeffs @ deltas."""
    if not K.on_cuda(w, deltas, coeffs):
        return calibrate_update_ref(w, deltas, coeffs)
    if w.dim() != 1 or deltas.dim() != 2 or coeffs.dim() != 1:
        raise ValueError("calibrate_update takes w (P,), deltas (M,P), "
                         "coeffs (M,)")
    m, p = deltas.shape
    if w.shape[0] != p or coeffs.shape[0] != m:
        raise ValueError(f"shapes w {tuple(w.shape)}, deltas "
                         f"{tuple(deltas.shape)}, coeffs {tuple(coeffs.shape)}"
                         f" do not agree")
    for name, t in (("w", w), ("deltas", deltas), ("coeffs", coeffs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(w)
    vec = p % 4 == 0 and K.aligned16(w, deltas, out)
    err = K.load_library().repro_calibrate(
        w.data_ptr(), deltas.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
        m, p, int(vec), K.stream_of(w))
    K.check_launch(err, "calibrate")
    K.LAUNCHES["calibrate"] += 1
    return out
