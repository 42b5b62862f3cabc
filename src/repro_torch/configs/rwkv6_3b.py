"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536,
RWKV-6 "Finch" data-dependent decay linear attention. [arXiv:2404.05892]

The port runs one rwkv layer (``models.rwkv6``: time-mix through the wkv
kernels, channel-mix) at this width.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # 2560 / rwkv_head_dim(64)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    norm_type="layernorm",
    act="silu",
    source="arXiv:2404.05892",
)
