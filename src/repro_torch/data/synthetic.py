"""Synthetic datasets standing in for MNIST/Fashion-MNIST/CIFAR-10 and Tiny
Shakespeare.  A numpy copy of ``repro.data.synthetic`` with the same RNG
calls, so the same seed gives the same bytes.

* image data: class-conditional smooth Gaussian patterns + pixel noise,
  learnable by the paper's CNN within a few epochs.
* char data: a seeded stochastic grammar (zipf-weighted word inventory over a
  109-symbol alphabet, the paper's NanoGPT vocab), text with real n-gram
  structure so the LM loss drops during training.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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


def make_char_data(n_tokens: int, vocab_size: int = 109, seed: int = 0,
                   n_words: int = 400) -> np.ndarray:
    """Token stream with zipfian word structure (word = 2-8 symbol string)."""
    rng = np.random.default_rng(seed)
    space = 0
    words = [rng.integers(1, vocab_size, rng.integers(2, 9)).tolist()
             for _ in range(n_words)]
    ranks = np.arange(1, n_words + 1, dtype=np.float64)
    probs = (1 / ranks) / (1 / ranks).sum()
    out = []
    while len(out) < n_tokens:
        w = words[rng.choice(n_words, p=probs)]
        out.extend(w)
        out.append(space)
    return np.asarray(out[:n_tokens], np.int32)


def batch_iterator(data, labels, batch: int, seed: int = 0, epochs: int = 1):
    """Shuffled minibatches of ``batch`` examples, the tail dropped, one
    fresh permutation per epoch."""
    rng = np.random.default_rng(seed)
    n = len(data)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            yield data[idx], labels[idx]


def lm_examples(stream: np.ndarray, seq_len: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Chop a token stream into (tokens, labels) next-token pairs."""
    n = (len(stream) - 1) // seq_len
    toks = stream[: n * seq_len].reshape(n, seq_len)
    labs = stream[1: n * seq_len + 1].reshape(n, seq_len)
    return toks.astype(np.int32), labs.astype(np.int32)
