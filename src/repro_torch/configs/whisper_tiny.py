"""whisper-tiny [audio] — 4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536,
vocab=51865, encoder-decoder. The mel-spectrogram + conv frontend is a STUB:
input_specs() provides post-conv frame embeddings (B, S_enc, d_model).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,          # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    frontend="audio",
    norm_type="layernorm",
    act="gelu",
    decoder_context=448,   # architectural decoder limit (model card)
    source="arXiv:2212.04356",
)
