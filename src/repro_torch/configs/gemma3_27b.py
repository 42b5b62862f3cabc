"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504,
vocab=262144, 5:1 local:global attention interleave, 128k context,
decoupled head_dim=128, sliding window 1024. [hf:google/gemma-3-1b-pt]

The port runs one local (sliding-window) layer at this width, its
attention through the ``window_attention`` kernels.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,                       # decoupled from d_model (gemma family)
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm_type="rmsnorm",
    act="gelu",
    source="hf:google/gemma-3-1b-pt",
)
