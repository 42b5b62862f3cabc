"""Config registry: ``get_config(arch_id)`` and the assigned-architecture
list.  The port carries every configuration of ``repro.configs`` whose
layers it runs: the paper CNN, the paper's NanoGPT, the dense llama3.2-3b,
olmo-1b, yi-6b and gemma3-27b, the MoE granite-moe-1b-a400m and
granite-moe-3b-a800m, jamba-1.5-large and rwkv6-3b.  internvl2-2b and
whisper-tiny arrive with their frontends (ROADMAP queue 1 item 5)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    FLConfig,
    ModelConfig,
    OptimizerConfig,
    SHAPES,
    ShapeConfig,
    reduce_for_smoke,
)

# arch id (as assigned) -> module name, in the reference's order
_ARCH_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "gemma3-27b": "gemma3_27b",
    "olmo-1b": "olmo_1b",
    "yi-6b": "yi_6b",
    "llama3.2-3b": "llama3p2_3b",
    "rwkv6-3b": "rwkv6_3b",
    # the paper's own models
    "nanogpt-paper": "nanogpt_paper",
    "cnn-paper": "cnn_paper",
}

ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES if not k.endswith("-paper"))


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
