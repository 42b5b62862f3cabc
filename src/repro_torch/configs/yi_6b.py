"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-architecture GQA. [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    norm_type="rmsnorm",
    act="silu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
