"""Top-level model API: init / loss / predict for the paper CNN.

``init_params(cfg, seed, device)``   -> parameter dict (real tensors)
``loss_fn(cfg)(params, batch)``      -> (loss, metrics) for one model
``stacked_loss_fn(cfg)(params, b)``  -> (B,) losses of a stack of B models
``predict_fn(cfg)(params, batch)``   -> logits of one model
``stacked_predict_fn(cfg)``          -> logits of a stack of B models
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.cnn import cnn_forward, cnn_forward_stacked, init_cnn
from repro_torch.models.params import Device


def _require_cnn(cfg: ModelConfig) -> None:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port runs "
            f"the paper CNN")


def init_params(cfg: ModelConfig, seed: int = 0, device: Device = "cpu"):
    """Draw the model's parameters from a generator seeded ``seed`` (on the
    CPU, so the draw does not depend on the device) and move them."""
    _require_cnn(cfg)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return {k: v.to(device) for k, v in init_cnn(cfg, gen).items()}


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL of log_softmax in fp32 over the last batch axis."""
    ll = torch.log_softmax(logits.float(), dim=-1)
    gold = ll.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -gold.mean(-1)


def stacked_loss_fn(cfg: ModelConfig):
    """fn(params (B, ...), batch {"images": (B, n, ...), "labels": (B, n)})
    -> (B,) per-model mean losses; gradients of their sum are each model's
    own gradients."""
    _require_cnn(cfg)

    def loss(params, batch):
        return _nll(cnn_forward_stacked(params, batch["images"]),
                    batch["labels"])
    return loss


def loss_fn(cfg: ModelConfig):
    """Returns fn(params, batch) -> (loss, metrics) for one model."""
    _require_cnn(cfg)

    def cnn_loss(params, batch):
        logits = cnn_forward(params, batch["images"])
        labels = batch["labels"]
        loss = _nll(logits, labels)
        acc = (logits.argmax(-1) == labels.long()).float().mean()
        return loss, {"loss": loss, "acc": acc}
    return cnn_loss


def predict_fn(cfg: ModelConfig):
    _require_cnn(cfg)
    return lambda params, batch: cnn_forward(params, batch["images"])


def stacked_predict_fn(cfg: ModelConfig):
    _require_cnn(cfg)
    return lambda params, batch: cnn_forward_stacked(params, batch["images"])
