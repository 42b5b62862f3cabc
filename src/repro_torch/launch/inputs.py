"""Input specs of every model input (``repro.launch.inputs``): empty
tensors on the ``meta`` device, the counterpart of the reference's
``jax.ShapeDtypeStruct``: a shape and a dtype, no memory.  Tokens and
labels are int32; audio frames and vision patches arrive as precomputed
embeddings of the right shape (the reference's one stub) in the config's
compute dtype."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig

AUDIO_ENC_FRAMES = 1500   # whisper's 30 s window after the conv frontend


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      fl: FLConfig) -> Dict[str, torch.Tensor]:
    """Client-serial FedAvg layout: (n_clients, per_client_batch, ...)."""
    nc = fl.fl_clients_per_step
    bpc = shape.global_batch // nc
    assert bpc * nc == shape.global_batch
    s = shape.seq_len
    out = {"tokens": _spec((nc, bpc, s), torch.int32),
           "labels": _spec((nc, bpc, s), torch.int32)}
    cdt = _compute_dtype(cfg)
    if cfg.family == "vlm":
        out["patches"] = _spec((nc, bpc, cfg.vision_tokens, cfg.d_model),
                               cdt)
    if cfg.family == "audio":
        out["frames"] = _spec((nc, bpc, AUDIO_ENC_FRAMES, cfg.d_model), cdt)
    return out


def prefill_batch_specs(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _spec((b, s), torch.int32)}
    cdt = _compute_dtype(cfg)
    if cfg.family == "vlm":
        out["patches"] = _spec((b, cfg.vision_tokens, cfg.d_model), cdt)
    if cfg.family == "audio":
        out["frames"] = _spec((b, AUDIO_ENC_FRAMES, cfg.d_model), cdt)
    return out


def decode_token_specs(shape: ShapeConfig) -> torch.Tensor:
    return _spec((shape.global_batch, 1), torch.int32)


def cache_len_for(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(cache_len, enc_len) for the decode cache."""
    cache_len = shape.seq_len + (cfg.vision_tokens if cfg.family == "vlm"
                                 else 0)
    enc_len = AUDIO_ENC_FRAMES if cfg.family == "audio" else 0
    return cache_len, enc_len
