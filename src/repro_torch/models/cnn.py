"""ResNet-18-style CNN of the GenFV experiments (paper Sec. VI), the
counterpart of the JAX package's `models/cnn.py`.

Plain functions over a parameter tree with the JAX package's names:

    {"stem": [C0,3,3,3], "gn_stem": {"scale", "bias"},
     "stages": [[{"conv1", "gn1", "conv2", "gn2", ("proj", "gn_proj")}, ...], ...],
     "head": {"w": [C, classes], "b": [classes]}}

Convolution weights are OIHW (the JAX package keeps HWIO), activations
NCHW; `convert.from_jax_cnn_params` maps one tree onto the other. GroupNorm
stands in for BatchNorm, as in the JAX package.

Two details carry the JAX numerics:
* padding "SAME" on a stride-2 convolution pads (0, 1), not (1, 1): the
  input is padded explicitly and the convolution runs with padding 0;
* GroupNorm takes min(8, C) groups, decremented until it divides C, with
  the biased variance and eps 1e-5.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models.api import resolve_device


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """"SAME" convolution: x [B, C, H, W], w [O, C, k, k] -> [B, O, H/s, W/s]."""
    k = w.shape[-1]
    ph = _same_pads(x.shape[-2], k, stride)
    pw = _same_pads(x.shape[-1], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def num_groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def groupnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x, num_groups(x.shape[1]), p["scale"], p["bias"], eps)


def _block_apply(p, x, stride: int):
    h = F.relu(groupnorm(p["gn1"], conv2d(p["conv1"], x, stride)))
    h = groupnorm(p["gn2"], conv2d(p["conv2"], h))
    if "proj" in p:
        x = groupnorm(p["gn_proj"], conv2d(p["proj"], x, stride))
    return F.relu(x + h)


def cnn_forward(params, cfg, images: torch.Tensor) -> torch.Tensor:
    """images: [B, C, H, W] float. Returns logits [B, num_classes]."""
    x = F.relu(groupnorm(params["gn_stem"], conv2d(params["stem"], images)))
    for s, stage in enumerate(params["stages"]):
        for b, bp in enumerate(stage):
            x = _block_apply(bp, x, 2 if (b == 0 and s > 0) else 1)
    x = x.mean((2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def cnn_loss(params, cfg, images: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy in fp32 over the batch; returns (loss, logits)."""
    logits = cnn_forward(params, cfg, images)
    ll = F.log_softmax(logits.float(), dim=-1)
    ce = -ll.gather(-1, labels[:, None])[:, 0]
    return ce.mean(), logits


def init_cnn(gen: torch.Generator, cfg, device="cuda") -> Dict[str, Any]:
    """Random parameters on `device`, drawn from `gen` (which must lie there)
    with the JAX package's laws: He-normal convolutions (std sqrt(2/fan_in)),
    head N(0, 1/C), GroupNorm scale 1 and bias 0. Torch cannot draw JAX's
    threefry streams, so the values differ from `repro.models.cnn.init_cnn`;
    `convert.from_jax_cnn_params` carries those over where a test needs them."""
    device = resolve_device(device)
    if gen.device != device:
        raise ValueError(f"generator lies on {gen.device}, the parameters "
                         f"go to {device}")

    def conv(k, c_in, c_out):
        w = torch.randn((c_out, c_in, k, k), generator=gen, device=device)
        return w * (2.0 / (k * k * c_in)) ** 0.5

    def gn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    w0 = int(cfg.stem_width * cfg.width_mult)
    widths = [w0, 2 * w0, 4 * w0, 8 * w0]
    params: Dict[str, Any] = {"stem": conv(3, cfg.channels, w0),
                              "gn_stem": gn(w0), "stages": []}
    c_in = w0
    for s, (c_out, n) in enumerate(zip(widths, cfg.stage_blocks)):
        stage: List[dict] = []
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            p = {"conv1": conv(3, c_in, c_out), "gn1": gn(c_out),
                 "conv2": conv(3, c_out, c_out), "gn2": gn(c_out)}
            if stride != 1 or c_in != c_out:
                p["proj"] = conv(1, c_in, c_out)
                p["gn_proj"] = gn(c_out)
            stage.append(p)
            c_in = c_out
        params["stages"].append(stage)
    params["head"] = {
        "w": torch.randn((c_in, cfg.num_classes), generator=gen,
                         device=device) * (1.0 / c_in) ** 0.5,
        "b": torch.zeros(cfg.num_classes, device=device)}
    return params
