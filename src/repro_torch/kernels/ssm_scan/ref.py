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


LOG2E = 1.4426950408889634


def ssm_abar(dt, a):
    """abar = exp(dt a) of every (sequence, step, channel, state), as the
    kernels form it: exp2(dt (a log2 e)), in float32.  (B, S, D, n)."""
    al = expand_groups(a.float(), dt.shape[0]) * LOG2E       # (B, D, n)
    return torch.exp2(dt.float()[..., None] * al[:, None])


def ssm_advance(h, abar_t, dtx_t, b_t):
    """One step of the recurrence: h <- abar h + (dt x) b."""
    return abar_t * h + dtx_t[..., None] * b_t[:, None, :]


def ssm_scan_subchunk_ref(dt, b, c, x, a, h0, subs: int = 8,
                          chunk: int = 8):
    """The forward kernel's own algorithm as a float32 loop.  Time is cut
    into sub-chunks of ``chunk`` steps (the backward's checkpoint
    interval) and tiles of ``subs`` sub-chunks.  With ``subs`` > 1 (the
    time split) each sub-chunk first forms its composite, the product of
    its abar and its h from zero; the composites of a tile are folded in
    order onto the tile's carry, giving each sub-chunk's start (its
    checkpoint), and the next tile's carry is the last start folded once
    more.  Each sub-chunk is then walked from its start with ``ssm_advance``
    as the backward's recompute walks it, and y comes from that walk; h_last
    is the end of the walk of the sub-chunk holding step S-1.  With
    ``subs`` = 1 the sub-chunks are walked in turn and each checkpoint is
    the walk's h.

    Returns (y (B,S,D), h_last (B,D,n), ckpt (B, ceil(S/chunk), D, n))."""
    bsz, s, d = dt.shape
    ab = ssm_abar(dt, a)
    dtx = dt.float() * x.float()
    bf, cf = b.float(), c.float()
    nck = -(-s // chunk)
    ys = torch.empty((bsz, s, d), dtype=torch.float32)
    ckpt = torch.empty((bsz, nck, d, b.shape[2]), dtype=torch.float32)
    carry = h0.float()
    h_last = None

    def walk(sub, h):
        for t in range(sub * chunk, min(s, (sub + 1) * chunk)):
            h = ssm_advance(h, ab[:, t], dtx[:, t], bf[:, t])
            ys[:, t] = torch.einsum("bn,bdn->bd", cf[:, t], h)
        return h

    for first in range(0, nck, subs):
        tile = range(first, min(nck, first + subs))
        if subs == 1:
            ckpt[:, first] = carry
            carry = walk(first, carry)
            h_last = carry
            continue
        comps = []
        for sub in tile:
            pr, hl = None, torch.zeros_like(carry)
            for t in range(sub * chunk, min(s, (sub + 1) * chunk)):
                pr = ab[:, t] if pr is None else pr * ab[:, t]
                hl = ssm_advance(hl, ab[:, t], dtx[:, t], bf[:, t])
            comps.append((pr, hl))
        start = carry
        for sub, (pr, hl) in zip(tile, comps):
            ckpt[:, sub] = start
            end = walk(sub, start)
            if sub == nck - 1:
                h_last = end
            start = pr * start + hl
        carry = start
    return ys, h_last, ckpt
