"""Configuration dataclasses of the port: the model, the input shapes, the
federation and the optimizer.  Field names and defaults follow
``repro.configs.base``; the federation keeps only the fields the port's
paths read.  ``param_count``, ``active_param_count`` and
``reduce_for_smoke`` are the reference's integer arithmetic."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters, with ``repro.configs.base``'s field
    names and defaults.

    ``family`` selects the block stack; the port runs ``cnn`` (the paper's
    conv classifier) and, for the LM families, the ``global`` and ``local``
    attention layer kinds of ``dense`` and ``moe`` stacks, the ``mamba``
    layer kind of ``hybrid`` stacks and the ``rwkv`` layer kind of ``ssm``
    stacks, each with a dense or an MoE FFN.  The ``audio`` and ``vlm``
    frontends are not ported (ROADMAP queue 1), so the fields only they
    read (``encoder_layers``, ``decoder_context``, ``vision_tokens``) are
    left out.
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

    def param_count(self) -> int:
        """Analytic parameter count (matches init within rounding; the
        reference's audio encoder terms are left out with the frontend)."""
        d, h, kv, hd = (self.d_model, self.num_heads, self.num_kv_heads,
                        self.head_dim)
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings and self.family != "cnn":
            n += self.vocab_size * d                 # unembed
        for i, kind in enumerate(self.layer_kinds):
            if kind in ("global", "local"):
                n += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
                n += self._ffn_params(i)
                n += 2 * self._norm_params()
            elif kind == "mamba":
                di = self.ssm_expand * self.d_model
                n += d * 2 * di            # in_proj (x and z)
                n += di * self.ssm_conv_width
                n += di * (2 * self.ssm_state_dim + 1)  # B, C, dt projections
                n += di + di               # dt bias, A
                n += di * self.ssm_state_dim  # A matrix
                n += di * d                # out proj
                n += self._norm_params()
                n += self._ffn_params(i) + self._norm_params()
            elif kind == "rwkv":
                n += 4 * d * d             # r, k, v, g (time mix)
                n += d * d                 # output
                n += 2 * d                 # decay base, bonus u
                n += 5 * d + 32 * d * 2    # token-shift mixers + decay lora
                n += int(d * self.d_ff) + int(self.d_ff * d)  # channel-mix
                n += 2 * self._norm_params()
        n += self._norm_params()           # final norm
        return n

    def ffn_is_moe(self, layer_idx: int) -> bool:
        return bool(self.num_experts) and (
            layer_idx % self.moe_every == self.moe_every - 1)

    def _ffn_params(self, layer_idx: int = 0) -> int:
        if self.ffn_is_moe(layer_idx):
            e, f = self.num_experts, self.moe_d_ff
            return self.d_model * e + e * (3 * self.d_model * f)
        return 3 * self.d_model * self.d_ff  # gated mlp (gate, up, down)

    def _norm_params(self) -> int:
        return 0 if self.norm_type == "nonparametric" else self.d_model

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        e, k, f, d = (self.num_experts, self.experts_per_token,
                      self.moe_d_ff, self.d_model)
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.ffn_is_moe(i))
        return full - n_moe_layers * (e - k) * (3 * d * f)


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


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """2 layers, d_model <= 256, <= 4 experts: the same family and block
    wiring (``repro.configs.base.reduce_for_smoke``, without the frontend
    fields the port does not carry)."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    head_dim = max(d // heads, 16)
    # keep the layer pattern's first two kinds so hybrid wiring is exercised
    kinds = cfg.layer_kinds[:2] if cfg.num_layers >= 2 else cfg.layer_kinds
    if cfg.family == "hybrid":
        kinds = ("global", "mamba")  # make sure both block types are hit
    if cfg.family == "ssm":
        kinds = ("rwkv", "rwkv")
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.num_experts else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        layer_pattern=kinds,
        sliding_window=min(cfg.sliding_window, 64),
        rwkv_head_dim=min(cfg.rwkv_head_dim, max(d // 4, 16)),
        param_dtype="float32",
        compute_dtype="float32",
    )
