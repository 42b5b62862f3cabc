"""Roofline terms of a step on one H100 (``repro.roofline.analysis``).

    compute term = model_flops / peak FLOP/s
    memory term  = bytes the step must move / HBM bandwidth

``model_flops`` is the reference's, carried over as is: 6·N_active·D for
a training step, 2·N_active·D for prefill and decode.  The peak follows
the config's compute dtype (``peak_flops``): fp32 runs on the CUDA cores
(the port's fp32 GEMMs keep TF32 off, as the reference computes fp32),
bf16 and fp16 on the tensor cores.  The reference's
``analyze_compiled``, ``parse_collectives`` and ``hlo_cost.py`` read XLA's
compiled, partitioned HLO (loop-aware FLOPs, bytes and collectives of a
TPU pod); eager PyTorch compiles no such artefact, so their place is taken
by ``step_bytes``, an analytic count of the bytes a step must move, and
``step_terms``; a step sharded over a mesh adds a collective term, counted
from the collectives it issues (below).

The federated stage's training FLOPs are counted here too
(``train_step_flops``: every matrix product of one client's SGD step, and
the arithmetic inside the port's recurrence and window kernels, whose
formulas ``ssm_work``, ``wkv_work`` and ``window_work`` also give
``chip_smoke.py`` its kernels' bounds).

The collective term of a step sharded over a mesh is counted from what the
step issues: ``CollectiveTrace`` (a ``CommDebugMode`` that also records
each collective's result bytes and group size) watches one step, and
``collectives_of`` converts each record to the bytes that cross links
with the reference's ring formulas (``collective_link_bytes``, those of
``parse_collectives``), times the groups that run it at once; the same
trace counts the FLOPs each device runs on its local shards.

The card: NVIDIA H100 80GB HBM3 (SXM), power limit 700.00 W, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gave them
in this port's chip runs; the rates are NVIDIA's data sheet's dense peaks
at that limit.  A card set below 700 W runs slower under load.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models import mamba as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.models.layers import pad_vocab

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_FLOPS_TF32X3 = 495e12 / 3  # fp32-accurate products on the tensor
#                                 cores (three TF32 products each)
PEAK_FLOPS_BF16 = 989e12        # bf16 / fp16 on the tensor cores, dense
HBM_BW = 3.35e12                # bytes/s
HBM_BYTES = 80e9                # the card's memory, as the dry run budgets it
NVLINK_BW = 450e9               # bytes/s one way a card (NVLink 4, 18 links)

def peak_flops(compute_dtype: str) -> float:
    """The card's peak for a config's GEMMs in ``compute_dtype``."""
    return PEAK_FLOPS if compute_dtype == "float32" else PEAK_FLOPS_BF16


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) useful training FLOPs; decode
    and prefill use the forward-only 2*N*D."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens


def step_bytes(cfg, shape, param_bytes: int, cache_bytes: int = 0,
               fl=None, opt_state_bytes: int = 0) -> Dict[str, float]:
    """The bytes a step must move through HBM, by part (a lower bound:
    activations other than the logits are left out).

    train (one FedAvg round: ``fl.fl_clients_per_step`` clients of
    ``fl.fl_local_steps`` local steps, then the server optimizer): each
    local step reads the weights in forward and again in backward, writes
    the gradients, and its SGD update reads weights and gradients and
    writes the weights (6 passes); each client's delta joins the mean
    (its weights, the round's start, the accumulator read; the
    accumulator written: 4 passes); the server reads the pseudo-gradient
    twice (clip norm, scale), writes it once, then reads the weights,
    gradients and optimizer state and writes weights and state.  The
    logits (fp32, every token) are written in forward and read in
    backward.  prefill: the weights once, the cache written once, the
    last token's logits.  decode: the weights and the cache read once,
    the logits written."""
    p = float(param_bytes)
    if shape.kind == "train":
        nc, ls = fl.fl_clients_per_step, fl.fl_local_steps
        tokens = shape.global_batch * shape.seq_len
        parts = {"local_steps": nc * ls * 6 * p,
                 "client_means": nc * 4 * p,
                 "server": 3 * p + 3 * p + 2 * float(opt_state_bytes),
                 "logits": 2.0 * tokens * cfg.vocab_size * 4 * ls}
    else:
        parts = {"weights": p, "cache": float(cache_bytes),
                 "logits": shape.global_batch * cfg.vocab_size * 4.0}
    parts["total"] = sum(parts.values())
    return parts


def step_terms(flops: float, nbytes: float,
               peak: float = PEAK_FLOPS) -> Dict[str, object]:
    """The two roofline terms in seconds (``flops`` at ``peak``) and the
    dominant one."""
    terms = {"compute_s": flops / peak, "memory_s": nbytes / HBM_BW}
    return {**terms, "dominant": max(terms, key=terms.get)}



# ---------------------------------------------------------------------------
# The port's kernels: the work each forward or backward function needs
# ---------------------------------------------------------------------------

SSM_FWD_FLOPS = 6     # per (sequence, step, channel, state): dt*a, the
#                       decay and input products, the add, c*h and its sum
SSM_BWD_FLOPS = 20    # the h recompute (4) and the gradient formulas (16)
WKV_FWD_FLOPS = 4     # per (sequence, step, head, state element): the y
#                       FMA and the state FMA
WKV_BWD_FLOPS = 12    # 6 FMAs: the dr, dk, dlw and dv terms and the G
#                       update (2)


def ssm_work(bsz, s, d, n, g, backward: bool, train: bool = False,
             in_bytes: int = 4):
    """(bytes, flops, exps) the scan's forward or backward function needs:
    each input read once and each output written once (in training mode
    the forward also writes h every 8 steps); one exp per (sequence, step,
    channel, state).  ``in_bytes``: the forward's dt, x, b, c elements (2
    for its bf16 route; y and the state stay fp32)."""
    seq, st = bsz * s * d, bsz * s * n
    small = g * d * n + 2 * bsz * d * n          # a; h0 and h_last / dh0
    if backward:          # in: dt, x, gy, b, c, a, h0, g_hlast
        nbytes = 4 * (5 * seq + 4 * st + 2 * g * d * n + 3 * bsz * d * n)
    else:                 # in: dt, x, b, c, a, h0; out: y, h_last (, ckpt)
        nbytes = (in_bytes * (2 * seq + 2 * st)
                  + 4 * (seq + small
                         + (bsz * -(-s // 8) * d * n if train else 0)))
    work = bsz * s * d * n
    return nbytes, work * (SSM_BWD_FLOPS if backward else SSM_FWD_FLOPS), work


def wkv_work(bsz, s, h, n, g, backward: bool, train: bool = False,
             in_bytes: int = 4):
    """(bytes, flops, exps) the recurrence's forward or backward function
    needs: each input read once and each output written once (in training
    mode the forward also writes S every 64 steps); one exp per lw
    element.  ``in_bytes``: the forward's r, k, v, lw elements (2 for its
    bf16 route; y and the state stay fp32)."""
    seq, state = bsz * s * h * n, bsz * h * n * n
    if backward:    # in: r, k, v, lw, gy, u, h0, g_hlast; out: dr, dk, dv,
        #             dlw, du, dh0
        nbytes = 4 * (9 * seq + 2 * g * h * n + 3 * state)
    else:           # in: r, k, v, lw, u, h0; out: y, h_last (, ckpt)
        nbytes = in_bytes * 4 * seq + 4 * (
            seq + g * h * n + 2 * state
            + (state * -(-s // 64) if train else 0))
    work = bsz * s * h * n * n
    return nbytes, work * (WKV_BWD_FLOPS if backward else WKV_FWD_FLOPS), seq


def window_pairs(s: int, window: int) -> int:
    """(query, key) pairs of one head: sum over i < s of min(i + 1, w)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def window_work(b, s, h, kv, hd, window, backward: bool, in_bytes: int = 4):
    """(bytes, flops, exps) the attention's forward or backward function
    needs: each input read once and each output written once; 4 hd FLOPs
    per (query, key) pair forward (q.k and p v), 10 hd backward (the
    recomputed q.k, dO.v, dV, dQ, dK), one exp per pair.  ``in_bytes``:
    the forward's q, k, v and O elements (2 for its bf16 route; the
    log-sum-exp stays fp32)."""
    pairs = b * h * window_pairs(s, window)
    q_el, kv_el, rows = b * s * h * hd, b * s * kv * hd, b * h * s
    if backward:    # in: q, k, v, o, dO, lse; out: dq, dk, dv
        return 4 * (4 * q_el + 4 * kv_el + rows), 10 * hd * pairs, pairs
    return (in_bytes * (2 * q_el + 2 * kv_el) + 4 * rows, 4 * hd * pairs,
            pairs)


# ---------------------------------------------------------------------------
# Training FLOPs of one client's SGD step (the federated stage's count)
# ---------------------------------------------------------------------------

def _trained(fwd: int, input_grad: bool = True) -> int:
    """A product's forward FLOPs and its backward's: the weight's gradient
    always, the input's unless the input is data (autograd skips it)."""
    return fwd * (3 if input_grad else 2)


def _padded(n: int, block: int) -> int:
    """``n`` rounded up to a whole number of ``min(block, n)`` tiles."""
    t = min(block, n)
    return -(-n // t) * t


def _blockwise_pairs(sq: int, skv: int, block_q: int,
                     block_kv: int = 512) -> int:
    """Score-tile entries ``attention.blockwise_attention`` computes: every
    (block_q x block_kv) tile over the padded sequences, masked or not."""
    return _padded(sq, block_q) * _padded(skv, block_kv)


def _attention_pairs(cfg, s: int) -> int:
    """(query, key) score entries one head of a global layer computes at
    sequence length ``s`` (``attention.attention_layer``'s route)."""
    if cfg.attn_block_skip:          # causal_skip_attention
        bq = min(max(s // 16, 512), s)
        if s % bq or s % 512:
            return _blockwise_pairs(s, s, 512)
        return sum(_blockwise_pairs(bq, (i + 1) * bq, bq)
                   for i in range(s // bq))
    return _blockwise_pairs(s, s, cfg.attn_block_q or s)


def _moe_products(cfg, b: int, s: int, group_size: int = 512) -> int:
    """``models.moe.apply_moe``'s products for one model's (b, s) tokens,
    trained, as ``cfg.moe_impl`` dispatches them."""
    d, e, k, f = cfg.d_model, cfg.num_experts, cfg.experts_per_token, \
        cfg.moe_d_ff
    g = min(group_size, s)
    tokens = b * _padded(s, g)                   # N * T, S padded to groups
    cap = max(int(g * k / e * cfg.moe_capacity_factor), 4)
    slots = tokens // g * e * cap                # N * E * C expert rows
    total = _trained(2 * tokens * d * e)         # the router
    total += _trained(3 * 2 * slots * d * f)     # the experts' gated MLPs
    if cfg.moe_impl == "gather":
        return total + _trained(2 * tokens * k * d)      # gates x outputs
    # one-hot dispatch: the (token, choice) x slot tables (the dispatch
    # table has no gradient, the gate-weighted combine table the gates'
    # only), the dispatch of the tokens (their gradient only) and the
    # combine of the outputs
    table = 2 * tokens * k * e * cap
    total += table + 2 * table
    total += 2 * (2 * tokens * e * cap * d)              # expert inputs
    return total + _trained(2 * tokens * e * cap * d)    # outputs combined


def _lm_layer(cfg, kind: str, pat_idx: int, b: int, s: int
              ) -> Dict[str, int]:
    """One LM layer's trained products and kernel arithmetic."""
    t, d = b * s, cfg.d_model
    products, kernels = 0, 0
    if kind == "rwkv":
        h, n = rw.rwkv_heads(cfg)
        products += _trained(2 * t * d * d) * 6          # r, k, v, g, o, cr
        products += _trained(2 * t * d * rw.LORA_DIM) * 2    # decay's lora
        products += _trained(2 * t * d * cfg.d_ff) * 2      # ck, cv
        kernels += (wkv_work(b, s, h, n, 1, False)[1]
                    + wkv_work(b, s, h, n, 1, True)[1])
        return {"products": products, "kernels": kernels}
    if kind in ("global", "local"):
        hq, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        products += _trained(2 * t * d * hd * (2 * hq + 2 * kv))
        win = cfg.sliding_window if kind == "local" else 0
        if win and s > win:                              # window kernels
            kernels += (window_work(b, s, hq, kv, hd, win, False)[1]
                        + window_work(b, s, hq, kv, hd, win, True)[1])
        else:                                            # q.k and p v
            products += _trained(2 * 2 * b * hq * hd
                                 * _attention_pairs(cfg, s))
    elif kind == "mamba":
        di, n, r = mb.d_inner(cfg), cfg.ssm_state_dim, mb.dt_rank(cfg)
        products += _trained(2 * t * (d * 2 * di + di * (r + 2 * n)
                                      + r * di + di * d))
        kernels += (ssm_work(b, s, di, n, 1, False)[1]
                    + ssm_work(b, s, di, n, 1, True)[1])
    else:
        raise ValueError(f"layer kind {kind!r}")
    if cfg.ffn_is_moe(pat_idx):
        products += _moe_products(cfg, b, s)
    else:
        products += _trained(3 * 2 * t * d * cfg.d_ff)   # gate, up, out
    return {"products": products, "kernels": kernels}


def train_step_flops(cfg, batch: int, example_shape: Sequence[int]
                     ) -> Dict[str, int]:
    """FLOPs of one model's SGD step at ``batch`` examples of
    ``example_shape`` (the CNN's (H, W, C) image, an LM's (S,) tokens),
    forward and backward, from the config alone.

    ``products``: every matrix product the step executes (convolutions,
    dense and projection layers, attention's q.k and p v, the MoE router,
    dispatch and experts as ``moe_impl`` runs them, the unembedding) at
    2 FLOPs a multiply-add: forward once, backward twice (the input's and
    the weight's gradient), except the first layer's input gradient, which
    autograd skips for data.  ``kernels``: the arithmetic inside the
    port's hand-written kernels that the products leave out, forward and
    backward (the ``ssm_scan`` and ``wkv`` recurrences; window attention
    past its window), at the rates ``ssm_work``, ``wkv_work`` and
    ``window_work`` count.  ``total`` is their sum."""
    if cfg.family == "cnn":
        h, w, cin = example_shape
        c1, c2 = cfg.cnn_channels
        pix1, pix2 = h * w, (h // 2) * (w // 2)
        flat = (h // 4) * (w // 4) * c2
        products = (_trained(2 * batch * pix1 * 9 * cin * c1, False)
                    + _trained(2 * batch * pix2 * 9 * c1 * c2)
                    + _trained(2 * batch * flat * cfg.d_model)
                    + _trained(2 * batch * cfg.d_model * cfg.num_classes))
        return {"products": products, "kernels": 0, "total": products}
    if cfg.frontend:
        raise ValueError(f"{cfg.name}: the federated stage trains no "
                         f"{cfg.frontend} frontend")
    (s,) = example_shape
    plen = len(cfg.layer_pattern)
    parts = [_lm_layer(cfg, kind, i % plen, batch, s)
             for i, kind in enumerate(cfg.layer_kinds)]
    products = (sum(p["products"] for p in parts)
                + _trained(2 * batch * s * cfg.d_model
                           * pad_vocab(cfg.vocab_size)))
    kernels = sum(p["kernels"] for p in parts)
    return {"products": products, "kernels": kernels,
            "total": products + kernels}


# ---------------------------------------------------------------------------
# Collectives of a sharded step
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "permute")


def collective_link_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes crossing links for one collective over ``n`` participants,
    ``nbytes`` its per-device result (ring algorithms, the reference's
    ``parse_collectives``): all-reduce 2 (n-1) b (reduce-scatter then
    all-gather), all-gather (n-1) b, reduce-scatter (n-1) n b (the result
    is 1/n of the reduced input), all-to-all (n-1) b, permute n b."""
    if kind == "all-reduce":
        return 2 * (n - 1) * nbytes
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) * nbytes
    if kind == "reduce-scatter":
        return (n - 1) * nbytes * n
    if kind == "permute":
        return n * nbytes
    raise ValueError(f"collective kind {kind!r}")


_FUNCOL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = kwargs.get("group_name", args[-1] if args else None)
    return _resolve_process_group(name).size()


class CollectiveTrace(CommDebugMode):
    """``CommDebugMode`` that also records, for each functional collective
    DTensor issues, (kind, result bytes a device, group size) in
    ``records``, and counts the FLOPs of the ops this rank runs on its
    local shards in ``flops`` (``FlopCounterMode``'s formulas: matrix
    products, convolutions, attention; elementwise ops count 0)."""

    def __init__(self):
        super().__init__()
        self.records = []
        self.flops = 0
        self._counter = FlopCounterMode(display=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or not hasattr(func, "_overloadpacket"):
            return out
        packet = func._overloadpacket
        if packet in self._counter.flop_registry:
            self.flops += int(self._counter.flop_registry[packet](
                *args, **(kwargs or {}), out_val=out))
        kind = _FUNCOL_KIND.get(packet.__name__)
        if kind is not None:
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(t.numel() * t.element_size() for t in outs
                         if isinstance(t, torch.Tensor))
            self.records.append((kind, nbytes,
                                 _group_size(args, kwargs or {})))
        return out


def collectives_of(trace: CollectiveTrace, num_devices: int) -> Dict:
    """The reference's collective record (``parse_collectives``' keys)
    from a trace of one rank's step: each record's link bytes times the
    ``num_devices // n`` groups that run it at once."""
    per_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, nbytes, n in trace.records:
        groups = max(num_devices // max(n, 1), 1)
        per_kind[kind] += float(collective_link_bytes(kind, nbytes, n)
                                * groups)
        counts[kind] += 1
    return {"collective_bytes_total": sum(per_kind.values()),
            "collective_bytes_by_kind": per_kind,
            "collective_op_counts": counts,
            "flops_per_device": trace.flops}
