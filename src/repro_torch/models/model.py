"""Top-level model API: init / loss / predict, for the paper CNN and the
decoder LMs (``repro.models.model``).

``init_params(cfg, seed, device)``   -> parameter tree (real tensors)
``loss_fn(cfg)(params, batch)``      -> (loss, metrics) for one model
``stacked_loss_fn(cfg)(params, b)``  -> (K,) losses of a stack of K models
``predict_fn(cfg)(params, batch)``   -> logits of one model
``stacked_predict_fn(cfg)``          -> logits of a stack of K models

An LM batch is ``{"tokens": (.., bs, S), "labels": (.., bs, S)}`` with -100
labels ignored; the prefill/decode serving API arrives with serving.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.kernels import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.cnn import cnn_forward, cnn_forward_stacked, init_cnn
from repro_torch.models.params import Device, RealInit


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


def loss_fn(cfg: ModelConfig):
    """Returns fn(params, batch) -> (loss, metrics) for one model."""
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
        p1, b1 = _one(params, batch)
        logits, aux = tfm.forward_train(p1, cfg, b1)
        loss = _xent(logits, b1["labels"])[0] + aux[0]
        return loss, {"loss": loss, "aux": aux[0]}
    return lm_loss


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
