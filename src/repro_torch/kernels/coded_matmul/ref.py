"""Plain PyTorch versions of the coded matmul kernels (Lagrange encode / RS
decode core).  The wrappers use them for CPU tensors; ``chip_smoke.py`` holds
the CUDA kernels against them on the card."""
from typing import Optional

import torch


def coded_matmul_ref(coeff: torch.Tensor, w: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """coeff: (C, S); w: (S, P) -> (C, P) — eq. (6) when coeff is the encode
    matrix, eq. (7) when it is the decode (re-interpolation) matrix."""
    return (coeff.float() @ w.float()).to(out_dtype or torch.float32)


def coded_matmul_rounds_ref(coeff: torch.Tensor, w: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """coeff: (C, S); w: (G, S, P) -> (G, C, P): per-round ``coeff @ w[g]``."""
    out = torch.einsum("cs,gsp->gcp", coeff.float(), w.float())
    return out.to(out_dtype or torch.float32)


def coded_encode_decode_ref(enc: torch.Tensor, dec: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """enc: (C, S); dec: (S, C); w: (S, P) -> (S, P) = dec @ (enc @ w), the
    slice-verification round trip, in fp32."""
    return dec.float() @ (enc.float() @ w.float())
