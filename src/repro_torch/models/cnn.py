"""The paper's own FL model: the LEAF FEMNIST CNN (two 5x5 conv layers).

Architecture (LEAF benchmark, arXiv:1812.01097): 28x28x1 input ->
conv5x5(32) -> maxpool2 -> conv5x5(64) -> maxpool2 -> fc(2048) -> fc(62);
6,603,710 parameters at ``width=1``, 26.4 MB in float32.

The parameters are a plain dict in the reference package's layout (conv
weights HWIO, ``fc1`` rows in (h, w, c) order), so that the leaves, their
sizes and their compression are the reference's; :func:`forward` turns
the layout inside. Its math runs in full float32 (``full_float32``: no
TF32 in cuDNN's convolutions). Batches may be numpy arrays; they move to
the parameters' device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import DEFAULT_DEVICE, full_float32, resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.models.layers import softmax_cross_entropy

N_CLASSES = 62
IMG = 28


def _init(generator, n_classes: int, width: int,
          device: torch.device) -> dict:
    c1, c2, fc = 32 * width, 64 * width, 2048 * width
    flat = 7 * 7 * c2

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "conv1": {"w": normal((5, 5, 1, c1), 25 ** -0.5), "b": zeros(c1)},
        "conv2": {"w": normal((5, 5, c1, c2), (25 * c1) ** -0.5),
                  "b": zeros(c2)},
        "fc1": {"w": normal((flat, fc), flat ** -0.5), "b": zeros(fc)},
        "fc2": {"w": normal((fc, n_classes), fc ** -0.5),
                "b": zeros(n_classes)},
    }


def init_params(generator: torch.Generator, n_classes: int = N_CLASSES,
                width: int = 1, device=DEFAULT_DEVICE) -> dict:
    """Random float32 parameters at the reference's scales, drawn from
    ``generator`` (which must live on ``device``); ``width`` scales the
    channel counts (1 is the paper's model). They cannot equal
    ``jax.random``'s bits: the tests carry the reference's own through
    ``convert.cnn_params_from_reference``."""
    return _init(generator, n_classes, width, resolve_device(device))


def _device_of(params: dict) -> torch.device:
    return tree_leaves(params)[0].device


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    """NCHW conv, 5x5 'SAME' padding, of an HWIO weight."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=2)


def forward(params: dict, images) -> torch.Tensor:
    """images: (B, 28, 28, 1) float32 (NHWC) -> logits (B, n_classes)."""
    x = torch.as_tensor(images, device=_device_of(params))
    with full_float32():
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(_conv(x, params["conv1"])), 2)
        x = F.max_pool2d(F.relu(_conv(x, params["conv2"])), 2)
        # back to NHWC before the flatten: fc1's rows are (h, w, c)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
        return x @ params["fc2"]["w"] + params["fc2"]["b"]


def loss_fn(params: dict, batch: dict) -> torch.Tensor:
    logits = forward(params, batch["images"])
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    return softmax_cross_entropy(logits, labels)


def accuracy(params: dict, batch: dict) -> torch.Tensor:
    logits = forward(params, batch["images"])
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    return torch.mean((torch.argmax(logits, -1) == labels).float())


def param_bytes(params: dict) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(params))


def param_bits(params: dict) -> int:
    return 8 * param_bytes(params)
