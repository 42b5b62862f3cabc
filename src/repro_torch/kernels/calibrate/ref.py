"""Plain PyTorch version of the fused eq. (3) calibration update."""
import torch


def calibrate_update_ref(w: torch.Tensor, deltas: torch.Tensor,
                         coeffs: torch.Tensor) -> torch.Tensor:
    """w: (P,) current unlearned global; deltas: (M, P) retrained client
    updates; coeffs: (M,) = ||w^g_m|| / (M * ||w'^{g'}_m||) — eq. (3).

    Returns w + coeffs @ deltas.
    """
    return w.float() + coeffs.float() @ deltas.float()
