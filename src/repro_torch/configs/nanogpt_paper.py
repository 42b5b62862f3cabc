"""NanoGPT as used by the paper (Sec 5.1): 4-layer transformer, 4 attention
heads, embedding dim 16, vocab 109, trained on Tiny Shakespeare.
[Radford et al. 2019 / karpathy/nanoGPT]

The generation task's default family (``fl.families.TransformerFamily``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nanogpt-paper",
    family="dense",
    num_layers=4,
    d_model=16,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=109,
    norm_type="layernorm",
    act="gelu",
    param_dtype="float32",
    compute_dtype="float32",
    source="paper Sec 5.1 (nanoGPT)",
)
