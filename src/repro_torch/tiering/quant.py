"""int8 symmetric per-slice quantization, the warm/cold tier codec
(``repro.tiering.quant`` on torch).

A coded round is a ``(C, P)`` slice tensor (one Lagrange slice per client).
Each *row* gets its own symmetric scale ``amax / 127`` so a hot client's
large-magnitude slice cannot blow up the quantization error of its
neighbours.  The codec runs on the host in numpy float32, exactly as the
reference's does, so one float32 input gives byte-identical ``q`` and
``scales`` in both packages; a device tensor (f32 or bf16) is taken to the
host once, as float32.

Determinism contract: once a round is quantized its ``(q, scales)`` payload
is canonical.  Re-quantizing a *dequantized* tensor with the SAME stored
scales reproduces ``q`` bit-exactly (the dequantized values sit within a few
float32 ulps of the integer grid points, far inside the rint rounding
window), which is what makes promote→demote→read bit-stable without keeping
the int8 payload resident.  The tiered store therefore always passes the
entry's stored ``scales`` back into :func:`quantize_int8` when it re-demotes
a lossy round.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host_f32(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        # one blocking device-to-host copy, as float32 (bf16 widens exactly)
        return arr.detach().to(torch.float32).cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def quantize_int8(arr, scales: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a ``(C, P)`` slice tensor to ``(q int8 (C, P), scales f32
    (C,))`` with symmetric per-row scales ``amax / 127`` (zero rows get
    scale 1.0 so dequantization is always well-defined).

    Passing previously stored ``scales`` skips the amax recompute and makes
    requantization of a dequantized tensor bit-exact (see module docstring).
    """
    a = _host_f32(arr)
    if a.ndim != 2:
        raise ValueError(f"expected a (C, P) slice tensor, got {a.shape}")
    if scales is None:
        amax = np.abs(a).max(axis=1)
        scales = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    else:
        scales = np.asarray(scales, dtype=np.float32)
        if scales.shape != (a.shape[0],):
            raise ValueError(f"scales shape {scales.shape} != ({a.shape[0]},)")
    q = np.clip(np.rint(a / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def dequantize_int8(q: np.ndarray, scales: np.ndarray,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Reconstruct the slice tensor in ``dtype`` (the tier's original hot
    dtype, so downstream decode sees the shapes/dtypes it always saw) on
    ``device`` (the CPU when None).  The multiply runs on the host into a
    fresh array (``q`` may be a read-only ``np.memmap``); one host-to-device
    copy follows, completed before this returns."""
    a = np.asarray(q).astype(np.float32) * \
        np.asarray(scales, np.float32)[:, None]
    t = torch.from_numpy(a)
    dev = torch.device(device) if device is not None else t.device
    if dev.type == "cuda":
        t = t.to(device=dev, dtype=dtype)
        # the upload lands on this thread's stream; another slot's stream
        # may read the tensor next
        torch.cuda.current_stream(dev).synchronize()
        return t
    return t.to(dtype=dtype)


def quant_error_bound(scales: np.ndarray) -> float:
    """Worst-case absolute reconstruction error per element: half a
    quantization step of the widest row, plus a few float32 ulps of
    headroom for the dequant multiply."""
    smax = float(np.asarray(scales, np.float32).max())
    return smax * (0.5 + 127 * float(np.finfo(np.float32).eps))
