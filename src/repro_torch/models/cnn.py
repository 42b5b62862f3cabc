"""The paper's CNN classifier: 2 conv + 2 pool + 2 fully-connected layers
(Sec 5.1).

Parameters keep the reference's layout (``repro.models.cnn``): HWIO conv
kernels, (in, out) dense weights, NHWC images, and the pooled activation
flattened in NHWC order, so ``fc1`` sees the features in the reference's
order.  The forward takes a stack of B models, each with its own batch of
images: the B convolutions run as one grouped convolution and the dense
layers as batched products, so the M clients of a shard (or the S*M
clients of a stage) train in one pass.  Kernels are permuted to OIHW only
inside the forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import draw


def init_cnn(cfg: ModelConfig, gen: torch.Generator) -> dict:
    c1, c2 = cfg.cnn_channels
    # after two 2x2 pools the spatial dim is image_size // 4
    flat = (cfg.image_size // 4) ** 2 * c2
    return {
        "conv1": draw(gen, (3, 3, cfg.image_channels, c1), scale=1.4,
                      in_dims=3),
        "b1": draw(gen, (c1,), init="zeros"),
        "conv2": draw(gen, (3, 3, c1, c2), scale=1.4, in_dims=3),
        "b2": draw(gen, (c2,), init="zeros"),
        "fc1": draw(gen, (flat, cfg.d_model)),
        "fb1": draw(gen, (cfg.d_model,), init="zeros"),
        "fc2": draw(gen, (cfg.d_model, cfg.num_classes)),
        "fb2": draw(gen, (cfg.num_classes,), init="zeros"),
    }


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    nb: int) -> torch.Tensor:
    """x (n, B*Cin, H, W); w (B, 3, 3, Cin, Cout) HWIO per model; b (B, Cout)
    -> (n, B*Cout, H//2, W//2): 'SAME' 3x3 conv, relu, 2x2 max pool."""
    cin, cout = w.shape[3], w.shape[4]
    k = w.permute(0, 4, 3, 1, 2).reshape(nb * cout, cin, 3, 3)
    y = F.conv2d(x, k, bias=b.reshape(nb * cout), padding=1, groups=nb)
    return F.max_pool2d(F.relu(y), 2)


def cnn_forward_stacked(params: dict, images: torch.Tensor) -> torch.Tensor:
    """params: stacked (B, ...) tree; images: (B, n, H, W, C) -> logits
    (B, n, num_classes), model b applied to images[b]."""
    nb, n, h, w, c = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(n, nb * c, h, w)
    x = _conv_relu_pool(x, params["conv1"], params["b1"], nb)
    x = _conv_relu_pool(x, params["conv2"], params["b2"], nb)
    c2, h2, w2 = x.shape[1] // nb, x.shape[2], x.shape[3]
    # back to NHWC before flattening, as the reference does
    x = x.reshape(n, nb, c2, h2, w2).permute(1, 0, 3, 4, 2).reshape(nb, n, -1)
    x = F.relu(torch.bmm(x, params["fc1"]) + params["fb1"].unsqueeze(1))
    return torch.bmm(x, params["fc2"]) + params["fb2"].unsqueeze(1)


def cnn_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (n, H, W, C) -> logits (n, num_classes) for one model."""
    stacked = {k: v.unsqueeze(0) for k, v in params.items()}
    return cnn_forward_stacked(stacked, images.unsqueeze(0))[0]
