"""Wrapper for the fused calibration kernel: CUDA tensors launch the kernel
in ``csrc/calibrate.cu``, CPU tensors run the plain version in ``ref.py``."""
from __future__ import annotations

import functools

import torch

from repro_torch import kernels as K
from repro_torch.kernels.calibrate.ref import calibrate_update_ref

TILE_P = 2048          # columns of P per block (kTileP in csrc/calibrate.cu)
MIN_SPLIT_ROWS = 32    # rows of M a split range takes at least
MAX_SPLITS = 8         # the portable cluster size (kMaxSplits there)


def calibrate_splits(m: int, p: int, sms: int) -> int:
    """How many ranges the kernel cuts the sum over M into: none when the
    column tiles alone give 4 blocks per SM, else as many as the rows allow
    (``MIN_SPLIT_ROWS`` each), at most ``MAX_SPLITS``.  So M < 64 is never
    split (the main path's M' = 4 keeps the sum m = 0 .. M-1)."""
    if -(-p // TILE_P) >= 4 * sms:
        return 1
    return max(1, min(MAX_SPLITS, m // MIN_SPLIT_ROWS))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def calibrate_update(w: torch.Tensor, deltas: torch.Tensor,
                     coeffs: torch.Tensor) -> torch.Tensor:
    """w: (P,), deltas: (M,P), coeffs: (M,) -> (P,) float32 = w + coeffs @
    deltas.  Each operand float32 or bfloat16: bf16 ones are widened here,
    as the TPU kernel's wrapper widens them (``.astype(jnp.float32)``)."""
    if not K.on_cuda(w, deltas, coeffs):
        return calibrate_update_ref(w, deltas, coeffs)
    for t in (w, deltas, coeffs):
        K.is_bf16(t)                     # float32 or bfloat16, else raise
    w, deltas, coeffs = w.float(), deltas.float(), coeffs.float()
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
    splits = calibrate_splits(m, p, _sms(w.device.index))
    err = K.load_library().repro_calibrate(
        w.data_ptr(), deltas.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
        m, p, splits, K.stream_of(w))
    K.check_launch(err, "calibrate")
    K.count_launch("calibrate")
    return out
