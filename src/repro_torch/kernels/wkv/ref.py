"""Plain PyTorch version of the RWKV-6 WKV recurrence: the sequential loop
of ``repro.kernels.wkv.ref.wkv_ref`` over all heads at once, with the
port's grouped ``u``.  Its backward is autograd through the loop.

``wkv_fwd_rowgroup_ref`` and ``wkv_bwd_sweeps_ref`` are the forward and
backward kernels' own algorithms as plain loops (used by the tests, not by
the model)."""
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


def wkv_fwd_rowgroup_ref(r, k, v, lw, u, h0, rows: int = 4):
    """The forward kernel's order of y's sum over rows, as a float32 loop.
    N is padded with zeros to NP = 16, 32 or 64 and the rows are taken in
    groups of ``rows``; group g gives
      p_gj = sum_{i in g} r_i S_ij + v_j sum_{i in g} (r_i u_i) k_i
    (each sum in row order: the u term folded into the row sum a group at
    a time), and y_j sums the groups by halving (g with g + G/2, then
    again), as the kernel's reduce-scatter over lanes does.  S_t = diag(w_t)
    S_{t-1} + k_t^T v_t.

    Returns (y (B,S,H,N), h_last (B,H,N,N))."""
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    bsz, s, hh, n = r.shape
    npad = 16 if n <= 16 else (32 if n <= 32 else 64)
    pad = (0, npad - n)
    r, k, v, lw = (torch.nn.functional.pad(t, pad) for t in (r, k, v, lw))
    u3 = torch.nn.functional.pad(expand_groups(u.float(), bsz), pad)
    h = torch.nn.functional.pad(h0.float(), (0, npad - n, 0, npad - n))
    w = torch.exp(lw)
    groups = npad // rows
    ys = []
    for t in range(s):
        rt = r[:, t].reshape(bsz, hh, groups, rows)
        kt = k[:, t].reshape(bsz, hh, groups, rows)
        ut = u3.reshape(bsz, hh, groups, rows)
        hg = h.reshape(bsz, hh, groups, rows, npad)
        p = torch.zeros((bsz, hh, groups, npad), dtype=torch.float32)
        ruk = torch.zeros((bsz, hh, groups), dtype=torch.float32)
        for m in range(rows):
            p = p + rt[..., m, None] * hg[:, :, :, m]
            ruk = ruk + rt[..., m] * ut[..., m] * kt[..., m]
        p = p + v[:, t, :, None, :] * ruk[..., None]
        while p.shape[2] > 1:
            half = p.shape[2] // 2
            p = p[:, :, :half] + p[:, :, half:]
        ys.append(p[:, :, 0, :n])
        h = w[:, t, :, :, None] * h + k[:, t, :, :, None] * v[:, t, :, None]
    return torch.stack(ys, dim=1), h[..., :n, :n]


def wkv_bwd_sweeps_ref(r, k, v, lw, u, h0, gy, ghl, chunk: int = 64):
    """The gradients of ``wkv_ref`` by the backward kernel's two sweeps, in
    float32.  gy: (B,S,H,N) and ghl: (B,H,N,N) are the cotangents of y and
    h_last; ``chunk`` is the forward's checkpoint interval.

    With G_t the cotangent of S_t, dlw_t = w_t Q_t, Q_t = rowsum(G_t *
    S_{t-1}).  Expanding G_t = diag(w_{t+1}) G_{t+1} + r_{t+1}^T gy_{t+1}
    and S_t = diag(w_t) S_{t-1} + k_t^T v_t, the term w_t w_{t+1}
    rowsum(G_{t+1} * S_{t-1}) is common to dlw_t and dlw_{t+1}, and
      dlw_t = dlw_{t+1} + w_t r_{t+1} (S_{t-1} gy_{t+1})
                        - w_{t+1} k_t (G_{t+1} v_t),
    each term scaled by a decay, so a decay near 0 costs no precision.

    Sweep A, each chunk from its own checkpoint (the state before its first
    step), t up: dr'_t = S_{t-1} gy_t and e_t = w_t r_{t+1} (S_{t-1}
    gy_{t+1}); at t = S-1 the direct dlw_{S-1} = w_{S-1} rowsum(ghl *
    S_{S-2}).  Sweep B, t down, S_{t-1} never needed:
      dk_t  = G_t v_t + u r_t (gy_t . v_t)
      dv_t  = G_t^T k_t + (sum r_t u k_t) gy_t
      dr_t  = dr'_t + u k_t (gy_t . v_t)
      dlw_t from dlw_{t+1} as above,  G_{t-1} = diag(w_t) G_t + r_t^T gy_t.

    Returns (dr, dk, dv, dlw, du shaped like u, dh0).
    """
    r, k, v, lw, gy = (t.float() for t in (r, k, v, lw, gy))
    bsz, s = r.shape[:2]
    u3 = expand_groups(u.float(), bsz)                       # (B,H,N)
    w = torch.exp(lw)
    ckpts, h = [], h0.float()
    for t in range(s):
        if t % chunk == 0:
            ckpts.append(h)
        h = w[:, t, :, :, None] * h + k[:, t, :, :, None] * v[:, t, :, None]
    # sweep A: the chunks are independent of each other
    drp, e = torch.empty_like(r), torch.zeros_like(r)
    for c, st in enumerate(ckpts):
        for t in range(c * chunk, min(s, (c + 1) * chunk)):
            drp[:, t] = torch.einsum("bhij,bhj->bhi", st, gy[:, t])
            if t + 1 < s:
                e[:, t] = w[:, t] * r[:, t + 1] * torch.einsum(
                    "bhij,bhj->bhi", st, gy[:, t + 1])
            else:
                dl = w[:, t] * (ghl.float() * st).sum(-1)
            st = w[:, t, :, :, None] * st \
                + k[:, t, :, :, None] * v[:, t, :, None]
    # sweep B
    g = ghl.float()
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u3)
    for t in reversed(range(s)):
        rt, kt, vt, gyt = r[:, t], k[:, t], v[:, t], gy[:, t]
        if t + 1 < s:
            dl = dl + e[:, t] - kt * wgv                     # dlw_t
        dlw[:, t] = dl
        gyv = (gyt * vt).sum(-1, keepdim=True)
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + u3 * rt * gyv
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) \
            + (rt * u3 * kt).sum(-1, keepdim=True) * gyt
        dr[:, t] = drp[:, t] + u3 * kt * gyv
        du = du + rt * kt * gyv
        if t > 0:                                            # w_t G_t v_{t-1}
            wgv = w[:, t] * torch.einsum("bhij,bhj->bhi", g, v[:, t - 1])
        g = w[:, t, :, :, None] * g + rt[..., None] * gyt[:, :, None]
    groups = 1 if u.dim() == 2 else u.shape[0]
    du = du.reshape(groups, bsz // groups, *du.shape[1:]).sum(1)
    return dr, dk, dv, dlw, du.reshape(u.shape), g
