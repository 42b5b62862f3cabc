"""Synthetic image data standing in for MNIST/Fashion-MNIST/CIFAR-10:
class-conditional smooth Gaussian patterns + pixel noise, learnable by the
paper's CNN within a few epochs.  A numpy copy of ``repro.data.synthetic``
with the same RNG calls, so the same seed gives the same bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ImageData:
    images: np.ndarray   # (N, H, W, C) float32 in [0,1]
    labels: np.ndarray   # (N,) int32


def make_image_data(n: int, num_classes: int = 10, image_size: int = 28,
                    channels: int = 1, noise: float = 0.35,
                    seed: int = 0, proto_seed: int = 1234) -> ImageData:
    """``seed`` draws the samples; ``proto_seed`` fixes the class prototypes,
    so different seeds give train/test splits of the SAME distribution."""
    proto_rng = np.random.default_rng(proto_seed)
    rng = np.random.default_rng(seed)
    # smooth class prototypes: superposed low-frequency sinusoids
    yy, xx = np.mgrid[0:image_size, 0:image_size] / image_size
    protos = np.zeros((num_classes, image_size, image_size, channels), np.float32)
    for c in range(num_classes):
        for ch in range(channels):
            for _ in range(3):
                fx, fy = proto_rng.uniform(1, 4, 2)
                ph = proto_rng.uniform(0, 2 * np.pi, 2)
                protos[c, :, :, ch] += np.sin(2 * np.pi * fx * xx + ph[0]) \
                    * np.sin(2 * np.pi * fy * yy + ph[1])
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-9)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = protos[labels] + noise * rng.standard_normal(
        (n, image_size, image_size, channels)).astype(np.float32)
    return ImageData(np.clip(images, 0, 1).astype(np.float32), labels)
