"""The paper's CNN classifier (Sec 5.1): 2 conv + 2 pool + 2 fully-connected
layers, for MNIST / Fashion-MNIST / CIFAR-10 classification.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="cnn-paper",
    family="cnn",
    d_model=128,             # fc hidden width
    cnn_channels=(16, 32),
    image_size=28,
    image_channels=1,
    num_classes=10,
    source="paper Sec 5.1 (CNN)",
)
