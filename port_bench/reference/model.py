"""The paper's ResNet-18 with GroupNorm, in plain PyTorch, float32.

Parameters are a tree in the program's layout:

    {"stem": [C0,3,3,3], "gn_stem": {"scale", "bias"},
     "stages": [[{"conv1", "gn1", "conv2", "gn2", ("proj", "gn_proj")}, ...]],
     "head": {"w": [C, classes], "b": [classes]}}

Convolutions are OIHW on NCHW activations with XLA's "SAME" padding (a
stride-2 3x3 convolution pads (0, 1)); GroupNorm takes min(8, C) groups,
the biased variance and eps 1e-5; the head follows a global mean pool.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def widths(model: dict) -> list[int]:
    w0 = int(model["stem_width"] * model["width_mult"])
    return [w0 * 2 ** s for s in range(len(model["stage_blocks"]))]


def layer_shapes(model: dict, image_size: int | None = None):
    """Every convolution and the head as (name, c_in, c_out, k, stride,
    h_in, w_in), in forward order."""
    size = image_size or model["image_size"]
    out = [("stem", model["channels"], widths(model)[0], 3, 1, size, size)]
    c_in = widths(model)[0]
    for s, (c_out, n) in enumerate(zip(widths(model), model["stage_blocks"])):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            out.append((f"s{s}b{b}.conv1", c_in, c_out, 3, stride, size, size))
            h = -(-size // stride)
            out.append((f"s{s}b{b}.conv2", c_out, c_out, 3, 1, h, h))
            if stride != 1 or c_in != c_out:
                out.append((f"s{s}b{b}.proj", c_in, c_out, 1, stride, size, size))
            size, c_in = h, c_out
    out.append(("head", c_in, model["num_classes"], 1, 1, 1, 1))
    return out


def count_params(model: dict) -> int:
    """Parameters of the model: each convolution's weight and the GroupNorm
    scale and bias after it, the head's weight and bias."""
    n = 0
    for name, c_in, c_out, k, *_ in layer_shapes(model):
        n += c_in * c_out * k * k + (c_out if name == "head" else 2 * c_out)
    return n


def leaves(tree) -> list:
    """Leaves in sorted-key order (lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, values):
    """`tree`'s structure with its leaves replaced by `values` (same order
    as `leaves`)."""
    it = iter(values)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        return next(it)
    return go(tree)


def init_params(model: dict, seed: int, device) -> dict:
    """Weights from `seed`, drawn on `device` in one call: He-normal
    convolutions (std sqrt(2 / fan_in)), head N(0, 1 / C), GroupNorm scale 1
    and bias 0, head bias 0."""
    w = widths(model)
    convs = [(w[0], model["channels"], 3, 3)]
    c_in = w[0]
    for s, (c_out, n) in enumerate(zip(w, model["stage_blocks"])):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            convs += [(c_out, c_in, 3, 3), (c_out, c_out, 3, 3)]
            if stride != 1 or c_in != c_out:
                convs.append((c_out, c_in, 1, 1))
            c_in = c_out
    shapes = convs + [(c_in, model["num_classes"])]
    sizes = [torch.Size(s).numel() for s in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    draws = iter(x.view(s) * (2.0 / (s[1] * s[2] * s[3]) if len(s) == 4
                              else 1.0 / s[0]) ** 0.5
                 for x, s in zip(torch.split(noise, sizes), shapes))

    def gn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    params = {"stem": next(draws), "gn_stem": gn(w[0]), "stages": []}
    c_in = w[0]
    for s, (c_out, n) in enumerate(zip(w, model["stage_blocks"])):
        stage = []
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            p = {"conv1": next(draws), "gn1": gn(c_out),
                 "conv2": next(draws), "gn2": gn(c_out)}
            if stride != 1 or c_in != c_out:
                p["proj"] = next(draws)
                p["gn_proj"] = gn(c_out)
            stage.append(p)
            c_in = c_out
        params["stages"].append(stage)
    params["head"] = {"w": next(draws),
                      "b": torch.zeros(model["num_classes"], device=device)}
    return params


# -- TF32, the control's precision -------------------------------------------
def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """float32 with TF32 off (the configuration's precision), or TF32 (the
    control). On CUDA TF32 is cuDNN's and cuBLAS's own; on the CPU, which
    has none, the operands of each convolution and matmul are rounded to
    TF32 and the products accumulate in float32, as the tensor cores do."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextlib.contextmanager
    def active(self, device):
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.tf32 and torch.device(device).type == "cuda"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def operands(self, *xs):
        if self.tf32 and xs[0].device.type != "cuda":
            # the rounded value forward, the gradient passed straight through
            return tuple(x + (_tf32_round(x.detach()) - x.detach()) for x in xs)
        return xs


FP32 = Precision(False)


def conv2d(w, x, stride: int = 1, prec: Precision = FP32):
    k = w.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    x, w = prec.operands(x, w)
    return F.conv2d(x, w, stride=stride)


def groups(c: int, g: int = 8) -> int:
    g = min(g, c)
    while c % g:
        g -= 1
    return g


def gnorm(p, x):
    return F.group_norm(x, groups(x.shape[1]), p["scale"], p["bias"], 1e-5)


def forward(params, x: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """x [B, 3, H, W] float32 -> logits [B, classes]."""
    x = F.relu(gnorm(params["gn_stem"], conv2d(params["stem"], x, 1, prec)))
    for s, stage in enumerate(params["stages"]):
        for b, p in enumerate(stage):
            stride = 2 if (b == 0 and s > 0) else 1
            h = F.relu(gnorm(p["gn1"], conv2d(p["conv1"], x, stride, prec)))
            h = gnorm(p["gn2"], conv2d(p["conv2"], h, 1, prec))
            if "proj" in p:
                x = gnorm(p["gn_proj"], conv2d(p["proj"], x, stride, prec))
            x = F.relu(x + h)
    x = x.mean((2, 3))
    x, w = prec.operands(x, params["head"]["w"])
    return x @ w + params["head"]["b"]


def loss(params, x, y, prec: Precision = FP32):
    """Mean cross-entropy over the batch."""
    return F.cross_entropy(forward(params, x, prec), y)


def sgd(params, batches, lr: float, prec: Precision = FP32, *, half_batch=False):
    """Plain SGD over `batches` ([(x [B,3,H,W], y [B]), ...]) from
    `params`; returns (the new tree, the mean of the steps' losses).
    `half_batch` is a planted fault for the check's readings: each step sees
    the first half of its batch."""
    ps = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    losses = []
    for x, y in batches:
        if half_batch:
            x, y = x[: len(y) // 2], y[: len(y) // 2]
        value = loss(rebuild(params, ps), x, y, prec)
        g = torch.autograd.grad(value, ps)
        losses.append(value.detach())
        with torch.no_grad():
            ps = [(p - lr * gi).requires_grad_(True) for p, gi in zip(ps, g)]
    return rebuild(params, [p.detach() for p in ps]), float(torch.stack(losses).mean())


#: a near tie: the true class within this share of (1 + the largest |logit|)
#: of the best other class
TIE = 1e-4


@torch.no_grad()
def count_correct(params, x: torch.Tensor, y: torch.Tensor, chunk: int = 1024,
                  prec: Precision = FP32) -> tuple[int, int, int]:
    """(images whose true class leads every other by more than the tie
    band, those plus the near ties, images whose argmax is the true
    class)."""
    sure = ties = hits = 0
    for i in range(0, len(y), chunk):
        logits = forward(params, x[i:i + chunk], prec)
        yi = y[i:i + chunk]
        true = logits.gather(1, yi[:, None])[:, 0]
        other = logits.scatter(1, yi[:, None], float("-inf")).max(1).values
        band = TIE * (1.0 + logits.abs().max(1).values)
        sure += int((true - other > band).sum())
        ties += int(((true - other).abs() <= band).sum())
        hits += int((logits.argmax(-1) == yi).sum())
    return sure, sure + ties, hits
