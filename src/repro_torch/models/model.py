"""Top-level model API: init / loss / predict / serve, for the paper CNN
and the LMs (``repro.models.model``).

``init_params(cfg, seed, device)``   -> parameter tree (real tensors)
``abstract_params(cfg, dtype)``      -> the same tree on the ``meta``
                                        device (shapes, no memory)
``param_axes(cfg)``                  -> the same tree of logical-axis
                                        tuples (LM families)
``loss_fn(cfg, remat, ctx)(params, batch)`` -> (loss, metrics) for one
                                        model
``stacked_loss_fn(cfg)(params, b)``  -> (K,) losses of a stack of K models
``predict_fn(cfg)(params, batch)``   -> logits of one model
``stacked_predict_fn(cfg)``          -> logits of a stack of K models
``prefill_fn(cfg, ctx, max_len)``, ``decode_fn(cfg, ctx)``,
``init_cache`` for serving one model.

An LM batch is ``{"tokens": (.., bs, S), "labels": (.., bs, S)}`` with -100
labels ignored, plus ``patches`` (vlm) or ``frames`` (audio) embeddings.
``loss_fn`` checkpoints each superblock by default (``remat="block"``, the
reference's default); ``stacked_loss_fn``, which the federated simulator's
small stacks train through, and ``predict_fn`` keep every activation
(``remat="none"``).  ``ctx`` (``transformer.ShardCtx``) lays a one-model
step out on a device mesh; its params and batch are then DTensors
(``launch.shardings``), and the loss runs under ``ctx.scope()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.cnn import cnn_forward, cnn_forward_stacked, init_cnn
from repro_torch.models.params import (NULL_CTX, AxesOnly, Device, RealInit,
                                       ShapeOnly)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        tfm.check_kinds(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device: Device = None):
    """Draw the model's parameters from a generator seeded ``seed`` (on the
    CPU, so the draw does not depend on the device) and move them to
    ``device`` — the CUDA card unless the caller passes ``"cpu"``."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    tree = (init_cnn(cfg, gen) if cfg.family == "cnn"
            else tfm.init_lm(RealInit(gen), cfg))
    dtype = getattr(torch, cfg.param_dtype)
    return tree_map(lambda v: v.to(dev, dtype), tree)


def abstract_params(cfg: ModelConfig, dtype=None):
    """The parameter tree as ``meta`` tensors in ``dtype`` (default the
    param dtype): every key and shape of ``init_params``, no memory
    allocated, nothing drawn (the reference's ``ShapeDtypeStruct`` tree)."""
    _check_family(cfg)
    dtype = dtype or cfg.param_dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if cfg.family == "cnn":     # a few hundred thousand values: drawn, then
        # dropped for their shapes
        gen = torch.Generator(device="cpu").manual_seed(0)
        return tree_map(lambda v: torch.empty(v.shape, dtype=dtype,
                                              device="meta"),
                        init_cnn(cfg, gen))
    return tfm.init_lm(ShapeOnly(dtype), cfg)


def param_axes(cfg: ModelConfig):
    """The parameter tree's logical-axis tuples, in the reference's keys
    (``repro.models.param_axes``).  The CNN (the paper's simulator model,
    never laid out on a mesh) has none here."""
    if cfg.family == "cnn":
        raise ValueError("param_axes covers the LM families")
    tfm.check_kinds(cfg)
    return tfm.init_lm(AxesOnly(), cfg)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL of log_softmax in fp32 over the last batch axis."""
    ll = torch.log_softmax(logits.float(), dim=-1)
    gold = ll.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -gold.mean(-1)


def _xent(logits: torch.Tensor, labels: torch.Tensor,
          ignore: int = -100) -> torch.Tensor:
    """Token cross-entropy per model: logits (K, ..., V), labels (K, ...)
    -> (K,), each the mean over that model's labels that are not
    ``ignore``."""
    k = labels.shape[0]
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = (logz - gold) * valid
    return nll.reshape(k, -1).sum(1) / valid.reshape(k, -1).sum(1).clamp_min(1)


def stacked_loss_fn(cfg: ModelConfig):
    """fn(params (K, ...), batch with a leading K axis) -> (K,) per-model
    losses; gradients of their sum are each model's own gradients."""
    _check_family(cfg)
    if cfg.family == "cnn":
        def loss(params, batch):
            return _nll(cnn_forward_stacked(params, batch["images"]),
                        batch["labels"])
        return loss

    def lm_loss(params, batch):
        logits, aux = tfm.forward_train(params, cfg, batch)
        return _xent(logits, batch["labels"]) + aux
    return lm_loss


def _one(params, batch):
    """One model's tree and batch as a stack of one."""
    return (tree_map(lambda v: v.unsqueeze(0), params),
            {k: v.unsqueeze(0) for k, v in batch.items()})


def loss_fn(cfg: ModelConfig, remat: str = "block", ctx=NULL_CTX):
    """Returns fn(params, batch) -> (loss, metrics) for one model;
    ``remat`` as ``transformer.forward_train`` takes it, ``ctx`` its
    sharding context (the LM families)."""
    _check_family(cfg)
    if cfg.family == "cnn":
        def cnn_loss(params, batch):
            logits = cnn_forward(params, batch["images"])
            labels = batch["labels"]
            loss = _nll(logits, labels)
            acc = (logits.argmax(-1) == labels.long()).float().mean()
            return loss, {"loss": loss, "acc": acc}
        return cnn_loss

    def lm_loss(params, batch):
        with ctx.scope():
            p1, b1 = _one(params, batch)
            logits, aux = tfm.forward_train(p1, cfg, b1, remat=remat,
                                            ctx=ctx)
            # the gold logit is gathered along the vocab: whole on a rank
            logits = ctx.constrain(logits, (None, "batch", "seq", None))
            loss = _xent(logits, b1["labels"])[0] + aux[0]
        return loss, {"loss": loss, "aux": aux[0]}
    return lm_loss


def num_params(params) -> int:
    return sum(v.numel() for v in tree_leaves(params))


def predict_fn(cfg: ModelConfig):
    _check_family(cfg)
    if cfg.family == "cnn":
        return lambda params, batch: cnn_forward(params, batch["images"])

    def fwd(params, batch):
        p1, b1 = _one(params, batch)
        return tfm.forward_train(p1, cfg, b1)[0][0]
    return fwd


def stacked_predict_fn(cfg: ModelConfig):
    _check_family(cfg)
    if cfg.family == "cnn":
        return lambda params, batch: cnn_forward_stacked(params,
                                                         batch["images"])
    return lambda params, batch: tfm.forward_train(params, cfg, batch)[0]


# ---------------------------------------------------------------------------
# Serving: one model, lifted to a stack of one
# ---------------------------------------------------------------------------

def _lift_cache(cache):
    """The public cache (no model axis) as the stack's: views, so the
    stack's in-place writes land in the caller's tensors (a DTensor's
    new leading model axis unsharded)."""
    return {"pos": cache["pos"],
            **{k: tree_map(lambda v: v.unsqueeze(0), cache[k])
               for k in ("stack", "rem")}}


def _drop_model_axis(cache):
    return {"pos": cache["pos"],
            **{k: tree_map(lambda v: v[0], cache[k])
               for k in ("stack", "rem")}}


def prefill_fn(cfg: ModelConfig, ctx=NULL_CTX,
               max_len: Optional[int] = None):
    """fn(params, batch) -> (last-token logits (B, 1, V), cache) of one
    model; the cache holds ``max(max_len, prompt)`` positions.  Under a
    ``ctx`` with a mesh the cache's leaves are DTensors in the cache
    layout of the context's rules."""
    def prefill(params, batch):
        with ctx.scope():
            p1, b1 = _one(params, batch)
            logits, cache = tfm.forward_prefill(p1, cfg, b1, ctx,
                                                max_len=max_len)
        return logits[0], _drop_model_axis(cache)
    return prefill


def decode_fn(cfg: ModelConfig, ctx=NULL_CTX):
    """fn(params, tokens (B, 1), cache) -> (logits (B, 1, V), cache): the
    cache's tensors are written in place (the reference donates its cache
    to the jitted step) and returned with the next ``pos``; a DTensor
    cache keeps its leaves' placements."""
    def step(params, tokens, cache):
        with ctx.scope():
            logits, new = tfm.forward_decode(
                tree_map(lambda v: v.unsqueeze(0), params), cfg,
                tokens.unsqueeze(0), _lift_cache(cache), ctx)
        return logits[0], _drop_model_axis(new)
    return step


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               enc_len: int = 0, device: Device = None):
    """An empty decode cache of one model on ``device`` (the card unless
    the caller passes ``"cpu"``), in ``dtype`` (default the compute
    dtype)."""
    dtype = dtype or cfg.compute_dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return _drop_model_axis(tfm.init_cache(cfg, batch, cache_len, dtype,
                                           enc_len, 1, device))
