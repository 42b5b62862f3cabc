"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave (each period
of 8 layers = 1 attention + 7 mamba), MoE FFN on every 2nd layer.
[arXiv:2403.19887]

The port runs its mamba mixer (``models.mamba.mamba_block``) at this width;
the attention and MoE layers arrive with their slices.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    moe_d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,                       # MoE on every other layer (jamba paper)
    layer_pattern=("global",) + ("mamba",) * 7,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    norm_type="rmsnorm",
    act="silu",
    source="arXiv:2403.19887",
)
