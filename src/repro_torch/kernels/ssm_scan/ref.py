"""Plain PyTorch version of the selective-SSM (mamba) scan: the straight
O(S) time loop of ``repro.kernels.ssm_scan.ref.ssm_scan_ref``, with the
port's grouped ``a``.  Its backward is autograd through the loop."""
import torch


def expand_groups(a: torch.Tensor, bsz: int) -> torch.Tensor:
    """``a`` (D, n) or (G, D, n) -> (B, D, n): sequence i uses
    a[i // (B // G)]."""
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    return a3.repeat_interleave(bsz // a3.shape[0], dim=0)


def ssm_scan_ref(dt, b, c, x, a, h0):
    """dt, x: (B,S,D); b, c: (B,S,n); a: (D,n) or (G,D,n), negative;
    h0: (B,D,n).

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * b_t * x_t
    y_t = sum_n c_t[n] * h_t[:, n]

    Returns (y (B,S,D) f32, h_last (B,D,n) f32).
    """
    a32 = expand_groups(a.float(), dt.shape[0])
    dt32 = dt.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt32[:, t]
        abar = torch.exp(dt_t[..., None] * a32)
        bu = dt_t[..., None] * b[:, t, None, :].float() \
            * x[:, t, :, None].float()
        h = abar * h + bu
        ys.append(torch.einsum("bn,bdn->bd", c[:, t].float(), h))
    return torch.stack(ys, dim=1), h
