"""Plain PyTorch version of the RWKV-6 WKV recurrence: the sequential loop
of ``repro.kernels.wkv.ref.wkv_ref`` over all heads at once, with the
port's grouped ``u``.  Its backward is autograd through the loop."""
import torch

from repro_torch.kernels.ssm_scan.ref import expand_groups


def wkv_ref(r, k, v, lw, u, h0):
    """r, k, v, lw: (B,S,H,N); u: (H,N) or (G,H,N), sequence b using
    u[b // (B // G)]; h0: (B,H,N,N) [key x value].

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t

    Returns (y (B,S,H,N) f32, h_last (B,H,N,N) f32).
    """
    u3 = expand_groups(u.float(), r.shape[0])[..., None]     # (B,H,N,1)
    h = h0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t].float(),
                               h + u3 * kv))
        h = torch.exp(lw[:, t].float())[..., None] * h + kv
    return torch.stack(ys, dim=1), h
