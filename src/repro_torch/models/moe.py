"""Mixture-of-Experts FFN on a stack of K models: top-k router and
capacity-based dispatch (``repro.models.moe``).

Every parameter leaf carries a leading model axis (K, ...) and the input is
(K, bs, S, d).  Tokens are routed within fixed-size groups of each model's
own tokens: (K, bs, S, d) -> (K, N, T, d) with T = min(group_size, S) and
N = bs * ceil(S / T); groups never mix models.  Each expert takes at most
``cap = max(int(T k / E * cfg.moe_capacity_factor), 4)`` (token, choice)
pairs of a group, in token-major order; the rest are dropped.

Two dispatch forms, picked by ``cfg.moe_impl``: ``einsum`` materialises
(K, N, T, E, C) one-hot dispatch and combine tensors, ``gather`` uses
integer slot indices and gathers.  The reference computes both outside any
Pallas kernel, so the port writes them as plain torch ops.  The expert
products (E, C, N, d) x (E, d, f) are batched over K and E.

On CUDA, ``gather``'s backward (``scatter_add``) adds in an order that may
change between runs, so its gradients match the ``einsum`` form's within
rounding, not bit for bit.

Under a ``ShardCtx`` with a mesh the token groups (``moe_group``) and the
experts' buffers (``expert``, ``moe_group``) are laid out at the
reference's six constraint points.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ACTS, matmul
from repro_torch.models.params import (NULL_CTX, Partial, Replicate, Shard,
                                       local_map, param, reshape, zero_pad)

GROUP_AXES = (None, "moe_group", None, None)           # (K, N, ., d)
BUF_AXES = (None, "expert", None, "moe_group", None)   # (K, E, C, N, d)
COMBINE_AXES = (None, "moe_group", None, "expert", None)  # (K, N, T, E, C)
EXPERT_W_AXES = (None, "expert", None, None)           # (K, E, ., .)


def init_moe(fac, cfg: ModelConfig):
    """The router (d, E) and the experts' gated MLPs (E, d, f) / (E, f, d).
    The experts' fan-in is d (and f for ``wo``), not E: the reference's
    ``fan_in`` arguments."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": param(fac, (d, e), ("embed", "expert_router")),
        "wi_gate": param(fac, (e, d, f), ("expert", "embed", "mlp"),
                         fan_in=d),
        "wi_up": param(fac, (e, d, f), ("expert", "embed", "mlp"),
                       fan_in=d),
        "wo": param(fac, (e, f, d), ("expert", "mlp", "embed"), fan_in=f),
    }


def _route(p, xg, cfg: ModelConfig, cap: int):
    """The shared router of a stack of K models: xg (K, N, T, d) ->
    (gate_vals, expert_idx, pos_in_expert, keep, onehot, aux).

    ``pos_in_expert`` (K, N, T, k) is each (token, choice)'s slot in its
    expert's capacity buffer, in token-major priority (flat index t k + j);
    pairs past ``cap`` are dropped through ``keep``.  ``aux`` (K,) is each
    model's load-balancing loss over its own tokens."""
    e, k = cfg.num_experts, cfg.experts_per_token
    km, n, g, _ = xg.shape
    logits = matmul(xg.float(), p["router"].float())          # (K,N,T,E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k breaks ties by the lower index, torch.topk in no set
    # order; a stable descending sort breaks them as the reference does
    # (the zero rows that pad S to a whole group tie across every expert,
    # and they count in the aux loss)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = srt[..., :k], order[..., :k]      # (K,N,T,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert_idx, e).float()                 # (K,N,T,k,E)
    flat = reshape(onehot, km, n, g * k, e)                    # token-major
    pos = reshape(torch.cumsum(flat, dim=2) - 1.0, km, n, g, k, e)
    pos_in_expert = (pos * onehot).sum(-1).to(torch.int32)    # (K,N,T,k)
    keep = pos_in_expert < cap
    me = probs.mean(dim=(1, 2))                               # (K,E)
    ce = onehot.sum(dim=3).mean(dim=(1, 2)) / k
    aux = cfg.router_aux_weight * e * (me * ce).sum(-1)       # (K,)
    return gate_vals, expert_idx, pos_in_expert, keep, onehot, aux


def _experts(p, expert_in, cfg: ModelConfig, ctx=NULL_CTX):
    """The experts' gated MLPs: (K, E, C, N, d) -> (K, E, C, N, d).  On a
    mesh they run on each rank's shards (``ctx.run_local``): its experts
    (``expert``) and token groups (``moe_group``), with those experts'
    weights whole (FSDP's shards of d and any split of f gathered, as
    FSDP gathers at use); an expert's MLP is per group, so nothing is
    communicated inside."""
    act = ACTS[cfg.act]

    def mlp(xin, wi_gate, wi_up, wo):
        h = act(torch.einsum("mecnd,medf->mecnf", xin, wi_gate)) * \
            torch.einsum("mecnd,medf->mecnf", xin, wi_up)
        return torch.einsum("mecnf,mefd->mecnd", h, wo)
    return ctx.run_local(mlp, (expert_in, p["wi_gate"], p["wi_up"], p["wo"]),
                         (BUF_AXES,) + (EXPERT_W_AXES,) * 3, outs=(0,))


def _combine(combine_t, expert_out, ctx=NULL_CTX):
    """combine_t (K, N, T, E, C) x expert_out (K, E, C, N, d) summed over
    the experts and their slots -> (K, N, T, d).  On a mesh each rank
    contracts its own token groups and experts (``local_map``), and the
    partial sums over a split of the experts are all-reduced: DTensor's
    own einsum flattens the split expert dim with the slots' (torch 2.11),
    which its view rule refuses."""
    def fn(a, b):
        return torch.einsum("mntec,mecnd->mntd", a, b)
    if ctx.mesh is None:
        return fn(combine_t, expert_out)
    a = ctx.constrain(combine_t, COMBINE_AXES)
    b = ctx.constrain(expert_out, BUF_AXES)
    out = tuple(Partial() if isinstance(q, Shard) and q.dim == 3 else q
                for q in a.placements)
    y = local_map(fn, out_placements=(out,),
                  in_placements=(tuple(a.placements), tuple(b.placements)),
                  device_mesh=ctx.mesh)(a, b)
    return y.redistribute(ctx.mesh, [Replicate() if q.is_partial() else q
                                     for q in out])


def _moe_einsum(p, xg, cfg: ModelConfig, cap: int, ctx=NULL_CTX):
    """One-hot dispatch: (K, N, T, E, C) dispatch and combine tensors, the
    choice axis contracted inside the einsums."""
    cdt = getattr(torch, cfg.compute_dtype)
    gate_vals, _idx, pos, keep, onehot, aux = _route(p, xg, cfg, cap)
    # F.one_hot refuses indices past cap - 1, which jax.nn.one_hot maps to
    # zero rows; those pairs are dropped by keep either way
    pos_oh = F.one_hot(pos.clamp(max=cap - 1).long(), cap).to(cdt) * \
        keep[..., None].to(cdt)                               # (K,N,T,k,C)
    oh = onehot.to(cdt)
    dispatch_t = torch.einsum("mntje,mntjc->mntec", oh, pos_oh)
    combine_t = torch.einsum("mntje,mntjc,mntj->mntec", oh, pos_oh,
                             gate_vals.to(cdt))
    expert_in = torch.einsum("mntec,mntd->mecnd", dispatch_t,
                             xg.to(cdt))                      # (K,E,C,N,d)
    expert_in = ctx.constrain(expert_in, BUF_AXES)
    expert_out = ctx.constrain(_experts(p, expert_in, cfg, ctx), BUF_AXES)
    return _combine(combine_t, expert_out, ctx), aux


def _moe_gather(p, xg, cfg: ModelConfig, cap: int, ctx=NULL_CTX):
    """Index dispatch: each buffer slot gathers its token, each (token,
    choice) gathers its slot's output.  Routing is ``_route``'s."""
    e, k = cfg.num_experts, cfg.experts_per_token
    km, n, g, d = xg.shape
    cdt = getattr(torch, cfg.compute_dtype)
    gate_vals, expert_idx, pos, keep, _onehot, aux = _route(p, xg, cfg, cap)
    # slot of each (token, choice) in the flat (E*C) buffer; dropped -> E*C
    slot = torch.where(keep, expert_idx * cap + pos.long(),
                       torch.full_like(expert_idx, e * cap))  # (K,N,T,k)
    tok_ids = torch.arange(g, device=xg.device).view(1, 1, g, 1).expand(
        km, n, g, k)
    # the token feeding each slot; g is the pad row.  Every dropped pair
    # writes the pad column E*C (in any order): it is cut off, never read.
    src = torch.full((km, n, e * cap + 1), g, dtype=torch.long,
                     device=xg.device)
    src.scatter_(2, reshape(slot, km, n, g * k),
                 reshape(tok_ids, km, n, g * k))
    buf_tok = src[..., :e * cap]                              # (K,N,E*C)
    xg_pad = torch.cat([xg.to(cdt), xg.new_zeros((km, n, 1, d), dtype=cdt)],
                       dim=2)
    expert_in = torch.gather(xg_pad, 2,
                             buf_tok[..., None].expand(km, n, e * cap, d))
    expert_in = reshape(expert_in, km, n, e, cap, d).permute(0, 2, 3, 1, 4)
    expert_in = ctx.constrain(expert_in, BUF_AXES)
    expert_out = ctx.constrain(_experts(p, expert_in, cfg, ctx),
                               BUF_AXES)                      # (K,E,C,N,d)
    flat_out = reshape(expert_out.permute(0, 3, 1, 2, 4), km, n, e * cap, d)
    flat_out = ctx.constrain(flat_out, GROUP_AXES)
    flat_out = torch.cat([flat_out, flat_out.new_zeros((km, n, 1, d))],
                         dim=2)
    picked = reshape(torch.gather(
        flat_out, 2, reshape(slot, km, n, g * k)[..., None].expand(
            km, n, g * k, d)), km, n, g, k, d)
    yg = torch.einsum("mntj,mntjd->mntd",
                      gate_vals.to(cdt) * keep.to(cdt), picked)
    return yg, aux


def apply_moe(p, x, cfg: ModelConfig, *, group_size: int = 512,
              ctx=NULL_CTX):
    """x (K, bs, S, d) -> (y (K, bs, S, d), aux (K,))."""
    km, b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g = min(group_size, s)
    pad = (-s) % g
    xp = zero_pad(x, 2, after=pad)
    ng = (s + pad) // g
    xg = ctx.constrain(reshape(xp, km, b * ng, g, d), GROUP_AXES)  # (K,N,T,d)
    cap = max(int(g * k / e * cfg.moe_capacity_factor), 4)
    impl = _moe_gather if cfg.moe_impl == "gather" else _moe_einsum
    yg, aux = impl(p, xg, cfg, cap, ctx)
    y = reshape(yg, km, b, s + pad, d)[:, :, :s].to(x.dtype)
    return y, aux
