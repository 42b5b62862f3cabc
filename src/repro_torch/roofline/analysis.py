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
``step_terms``.  One card has no collective term.

The card: NVIDIA H100 80GB HBM3 (SXM), power limit 700.00 W, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gave them
in this port's chip runs; the rates are NVIDIA's data sheet's dense peaks
at that limit.  A card set below 700 W runs slower under load.
"""
from __future__ import annotations

from typing import Dict

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_FLOPS_TF32X3 = 495e12 / 3  # fp32-accurate products on the tensor
#                                 cores (three TF32 products each)
PEAK_FLOPS_BF16 = 989e12        # bf16 / fp16 on the tensor cores, dense
HBM_BW = 3.35e12                # bytes/s
HBM_BYTES = 80e9                # the card's memory, as the dry run budgets it

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

