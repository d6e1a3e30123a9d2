"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
counterpart of the JAX package's `models/rglru.py`.

Block:  x -> [gate branch: GeLU(W_g x)]
           -> [rec branch: W_x x -> causal conv1d -> RG-LRU]
        y = W_out (gate * rec)

Prefill under impl="kernel" (the default) runs the scan through
`kernels.ops.rglru_scan`, with the incoming state as its initial state;
impl="torch" (the JAX package's `impl="jnp"`, which training runs) runs
`lru_scan` and folds the incoming state in afterwards, as the JAX package
does. Decode is the one-step update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import aconstrain
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, dense_init, init_conv1d

_C = 8.0


def init_rglru(gen, cfg, dtype, device):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_gate": dense_init(gen, d, w, dtype, device),
        "w_x": dense_init(gen, d, w, dtype, device),
        "conv": init_conv1d(gen, w, cfg.conv_kernel, dtype, device),
        "w_a": dense_init(gen, w, w, dtype, device),
        "w_i": dense_init(gen, w, w, dtype, device),
        "lam": torch.linspace(0.5, 4.0, w, device=device).to(dtype),
        "w_out": dense_init(gen, w, d, dtype, device),
    }


def _gates(p, u):
    """u: [..., w] (post-conv). Returns (log_a, beta*i*u) in fp32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float())
    i = torch.sigmoid(uf @ p["w_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return log_a, beta * i * uf


def lru_scan(log_a, b):
    """Linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t over axis 1 from
    h_0 = 0, as a loop over S in plain differentiable ops. The JAX
    package's `lru_scan` combines the same terms in an associative scan's
    tree order, so the two agree to float32 rounding, not bitwise.

    log_a, b: [B, S, W] fp32. Returns h: [B, S, W] fp32."""
    a = torch.exp(log_a)
    h = b[:, 0]
    hs = [h]
    for t in range(1, b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _by_width(scan, log_a, b, *h0):
    """scan(log_a, b, *h0); under an active DeviceMesh on local shards
    (batch over the data axes, width over 'model': the recurrence is
    elementwise over both)."""
    pl = autoshard.placements(b.shape, ("batch", None, "model"))
    pl_h = tuple(None if h is None else autoshard.placements(h.shape, ("batch", "model"))
                 for h in h0)
    return autoshard.local(scan, (pl, pl) + pl_h, (pl,))(log_a, b, *h0)


def rglru_block(p, x, cfg, state=None, impl: str = "kernel"):
    """x: [B, S, d]. state: None or {"h": [B,W] fp32, "conv": [B,K-1,W]}.
    impl: "kernel" or "torch" (module docstring).

    Returns (y [B,S,d], new_state)."""
    gate = aconstrain(F.gelu(x @ p["w_gate"], approximate="tanh"), ("batch", None, "model"))
    u = aconstrain(x @ p["w_x"], ("batch", None, "model"))
    u, new_conv = causal_conv1d(p["conv"], u, None if state is None else state["conv"])
    log_a, b = _gates(p, u)
    if state is not None and x.shape[1] == 1:
        # decode: single-step update
        h = torch.exp(log_a[:, 0]) * state["h"].float() + b[:, 0]
        h_seq, new_h = h[:, None], h
    elif impl == "kernel":
        # the incoming state is the scan's initial state
        h0 = None if state is None else state["h"].float()
        h_seq = _by_width(lambda la, bb, h0: ops.rglru_scan(
            la.contiguous(), bb.contiguous(), None if h0 is None else h0.contiguous()),
            log_a, b, h0)
        new_h = h_seq[:, -1]
    elif impl == "torch":
        h_seq = _by_width(lru_scan, log_a, b)
        if state is not None:
            # fold the incoming state into the whole scan: h_t += (prod a) h0
            h_seq = h_seq + torch.exp(torch.cumsum(log_a, dim=1)) * state["h"].float()[:, None]
        new_h = h_seq[:, -1]
    else:
        raise ValueError(f"unknown impl {impl!r}; 'kernel' or 'torch'")

    y = (gate * h_seq.to(x.dtype)) @ p["w_out"]
    new_state = None
    if state is not None:
        new_state = {"h": new_h.to(state["h"].dtype), "conv": new_conv}
    return y, new_state


def init_rglru_state(cfg, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype,
                                device=device)}
