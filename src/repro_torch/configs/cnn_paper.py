"""The paper's CNN classifier (Sec 5.1): 2 conv + 2 pool + 2 fully-connected
layers, for MNIST / Fashion-MNIST / CIFAR-10 classification.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="cnn-paper",
    family="cnn",
    num_layers=2,            # conv layers
    d_model=128,             # fc hidden width
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    cnn_channels=(16, 32),
    image_size=28,
    image_channels=1,
    num_classes=10,
    param_dtype="float32",
    compute_dtype="float32",
    source="paper Sec 5.1 (CNN)",
)
