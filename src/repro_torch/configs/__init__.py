"""Config registry: ``get_config(arch_id)``.  The port carries the paper
CNN, the paper's NanoGPT, jamba-1.5-large (whose mamba mixer it runs),
rwkv6-3b (whose rwkv layer it runs) and gemma3-27b (whose local attention
layer it runs); the other LLM configurations arrive with their model
families."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    FLConfig,
    ModelConfig,
    OptimizerConfig,
    SHAPES,
    ShapeConfig,
)

# arch id -> module name
_ARCH_MODULES = {
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "rwkv6-3b": "rwkv6_3b",
    "gemma3-27b": "gemma3_27b",
    "nanogpt-paper": "nanogpt_paper",
    "cnn-paper": "cnn_paper",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
