"""Model FLOPs of the GroupNorm ResNet-18, counted from its shapes.

A convolution of c_in -> c_out channels with a k x k kernel at an output of
h x w does 2 c_in c_out k^2 h w FLOPs a forward pass per image; the head
2 C classes. Backward does the same count twice (the input's gradient and
the weight's), except that no gradient flows into the images, so the stem
has only its weight gradient. GroupNorm, ReLU, the pool and the loss are
left out, as torch.utils.flop_counter leaves them out.
"""
from __future__ import annotations

from port_bench.reference.model import layer_shapes


def _layer(c_in, c_out, k, stride, h, w) -> float:
    return 2.0 * c_in * c_out * k * k * (-(-h // stride)) * (-(-w // stride))


def forward_flops(model: dict) -> float:
    """FLOPs of one image's forward pass."""
    return sum(_layer(*s[1:]) for s in layer_shapes(model))


def train_flops(model: dict) -> float:
    """FLOPs of one image's forward and backward pass."""
    shapes = layer_shapes(model)
    return 3.0 * forward_flops(model) - _layer(*shapes[0][1:])
