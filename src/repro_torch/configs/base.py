"""Configuration dataclasses of the port: the model, the federation and the
optimizer.  Field names and defaults follow ``repro.configs.base``; the
port keeps only the fields the paper CNN, its federation and sgd/sgdm
read (the transformer, MoE, SSM and adamw fields arrive with their code)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  ``family="cnn"`` is the paper's conv
    classifier (2 conv + 2 pool + 2 fully-connected layers)."""

    name: str
    family: str
    d_model: int                   # fc hidden width for the CNN
    source: str = ""

    # --- cnn (paper model) ---
    cnn_channels: Tuple[int, ...] = (16, 32)
    image_size: int = 28
    image_channels: int = 1
    num_classes: int = 10


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100          # C (paper Sec 5.1)
    clients_per_round: int = 20     # sampled per stage
    num_shards: int = 4             # S
    local_epochs: int = 10          # L
    global_rounds: int = 30         # G
    retrain_ratio: float = 2.0      # r  (retraining uses L/r local epochs)

    @property
    def clients_per_shard(self) -> int:
        return self.clients_per_round // self.num_shards


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgdm"         # sgd | sgdm (adamw arrives with the LMs)
    lr: float = 3e-4
    momentum: float = 0.9
    grad_clip: float = 1.0
