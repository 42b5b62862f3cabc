"""Configuration dataclasses of the port: the model, the input shapes, the
federation and the optimizer.  Field names and defaults follow
``repro.configs.base``; the federation keeps only the fields the port's
paths read."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters, with ``repro.configs.base``'s field
    names and defaults.

    ``family`` selects the block stack; the port runs ``cnn`` (the paper's
    conv classifier) and, for the LM families, the ``global`` and ``local``
    attention layer kinds of ``dense`` stacks, the ``mamba`` layer kind of
    ``hybrid`` stacks and the ``rwkv`` layer kind of ``ssm`` stacks.  MoE
    FFNs raise ``NotImplementedError`` until their slice lands (ROADMAP
    queue 1).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    source: str = ""

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0          # per-expert hidden dim (0 -> d_ff)
    moe_every: int = 1         # MoE FFN on every k-th layer
    moe_impl: str = "einsum"
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- layer pattern ---
    # Repeating pattern of layer kinds in {"global","local","mamba","rwkv"},
    # tiled to num_layers (remainder unrolled).
    layer_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096
    rope_theta: float = 10_000.0
    attn_block_skip: bool = False   # triangle-only causal blocks
    attn_block_q: int = 512         # q tile; 0 = whole seq
    ssm_chunk_dtype: str = "float32"  # the port's scan runs in float32 only
    mamba_impl: str = "chunked"       # both values run the ssm_scan kernel

    # --- ssm / rwkv ---
    ssm_state_dim: int = 16        # mamba d_state
    ssm_conv_width: int = 4        # mamba conv1d width
    ssm_expand: int = 2            # mamba d_inner = expand * d_model
    rwkv_head_dim: int = 64
    rwkv_impl: str = "chunked"     # both values run the wkv kernel

    # --- norm / misc ---
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm | nonparametric
    act: str = "silu"              # silu | gelu (tanh approximation) | relu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- frontends ---
    frontend: str = ""

    # --- cnn (paper model) ---
    cnn_channels: Tuple[int, ...] = (16, 32)
    image_size: int = 28
    image_channels: int = 1
    num_classes: int = 10

    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand layer_pattern to num_layers entries."""
        pat = self.layer_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    def ffn_is_moe(self, layer_idx: int) -> bool:
        return bool(self.num_experts) and (
            layer_idx % self.moe_every == self.moe_every - 1)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
}


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
    name: str = "adamw"        # adamw | adamw_bf16 | sgd | sgdm
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
