"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT vision encoder is a STUB: input_specs() provides projected patch
embeddings (B, 256, d_model); we implement the InternLM2 language backbone.
[arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    vision_tokens=256,
    norm_type="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
)
