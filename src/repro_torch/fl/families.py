"""Model-family registry — adapters that build a ``ModelConfig`` for one
``ScenarioConfig``, declare the task kind they play and name the kernel ops
their forward routes through.  The port carries every family of
``repro.fl.families``: the paper CNN, the paper's NanoGPT (the generation
task's default family), the mamba family (through the ``ssm_scan`` forward
and backward kernels), the rwkv6 family (through the ``wkv`` forward and
backward kernels) and the moe family (its router, dispatch and experts are
plain torch ops, as the reference's are plain jnp ops)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

from repro_torch.configs import ModelConfig, get_config


class ModelFamily:
    """Base class for family adapters.  Subclass, implement ``build``, and
    register with ``@register_model_family(name, *aliases)``."""

    name: str = ""
    task: str = "generation"            # task kind this family plays
    kernel_ops: Tuple[str, ...] = ()    # kernel ops the forward routes through
    default_lr: Optional[float] = None  # None -> the task's default
    default_batch: Optional[int] = None

    def build(self, cfg) -> ModelConfig:
        raise NotImplementedError


FAMILIES: Dict[str, Type[ModelFamily]] = {}


def register_model_family(*names: str):
    """Class decorator registering a ``ModelFamily`` under ``names``."""
    if not names:
        raise ValueError("register_model_family needs at least one name")

    def deco(cls: Type[ModelFamily]) -> Type[ModelFamily]:
        cls.name = names[0]
        for n in names:
            FAMILIES[n] = cls
        return cls
    return deco


def get_model_family(name: str) -> ModelFamily:
    try:
        return FAMILIES[name]()
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; registered: "
                         f"{sorted(FAMILIES)}") from None


def canonical_families() -> Tuple[str, ...]:
    """The registered families, one name per class, sorted."""
    return tuple(sorted({cls.name for cls in FAMILIES.values()}))


@register_model_family("cnn")
class CNNFamily(ModelFamily):
    """The paper's conv classifier at the reference's scenario scale
    (``repro.fl.families.CNNFamily``: channels 8/16, fc 48).  The full
    paper width is ``get_config("cnn-paper")`` itself."""

    task = "classification"

    def build(self, cfg) -> ModelConfig:
        return dataclasses.replace(get_config("cnn-paper"),
                                   image_size=cfg.image_size, d_model=48,
                                   cnn_channels=(8, 16))


@register_model_family("transformer", "nanogpt")
class TransformerFamily(ModelFamily):
    """The paper's NanoGPT (4 layers, d_model 16, 4 heads, vocab 109;
    ``repro.fl.families.TransformerFamily``).  Its global attention layers
    run the plain blockwise path, as the reference's do."""

    task = "generation"

    def build(self, cfg) -> ModelConfig:
        return get_config("nanogpt-paper")


_TINY_LM = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=109,
                param_dtype="float32", compute_dtype="float32")


@register_model_family("mamba")
class MambaFamily(ModelFamily):
    """Selective-SSM stack (jamba-style mamba blocks) training through the
    ``ssm_scan`` kernels (``repro.fl.families.MambaFamily``: 2 layers,
    d_model 32, d_inner 64, state 8, vocab 109 padded to 512)."""

    task = "generation"
    kernel_ops = ("ssm_scan",)
    default_lr = 0.1

    def build(self, cfg) -> ModelConfig:
        return ModelConfig(name="mamba-fl", family="hybrid",
                           layer_pattern=("mamba",), num_heads=4,
                           num_kv_heads=4, ssm_state_dim=8, ssm_expand=2,
                           mamba_impl="pallas", norm_type="layernorm",
                           act="gelu", source="scenario zoo (mamba)",
                           **_TINY_LM)


@register_model_family("rwkv6", "rwkv")
class RWKV6Family(ModelFamily):
    """Attention-free RWKV-6 stack training through the ``wkv`` kernels
    (``repro.fl.families.RWKV6Family``: 2 layers, d_model 32, 2 heads of
    16, d_ff 64, vocab 109 padded to 512)."""

    task = "generation"
    kernel_ops = ("wkv",)
    default_lr = 0.1

    def build(self, cfg) -> ModelConfig:
        return ModelConfig(name="rwkv6-fl", family="ssm",
                           layer_pattern=("rwkv",), num_heads=2,
                           num_kv_heads=2, rwkv_head_dim=16,
                           rwkv_impl="pallas", norm_type="layernorm",
                           act="silu", source="scenario zoo (rwkv6)",
                           **_TINY_LM)


@register_model_family("moe")
class MoEFamily(ModelFamily):
    """Mixture-of-experts FFN transformer (granite-style top-k routing;
    ``repro.fl.families.MoEFamily``: 2 global layers, d_model 32, 4 heads
    over 2 kv heads, 4 experts of width 32, top-2, vocab 109 padded to
    512) — per-client expert specialization under label/quantity skew."""

    task = "generation"
    default_lr = 0.1

    def build(self, cfg) -> ModelConfig:
        return ModelConfig(name="moe-fl", family="moe", num_heads=4,
                           num_kv_heads=2, num_experts=4,
                           experts_per_token=2, moe_d_ff=32,
                           norm_type="rmsnorm", act="silu",
                           source="scenario zoo (moe)", **_TINY_LM)
