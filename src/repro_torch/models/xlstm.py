"""xLSTM blocks (arXiv:2405.04517), the counterpart of the JAX package's
`models/xlstm.py`: mLSTM (matrix memory) and sLSTM (scalar memory with a
hidden-to-hidden recurrence).

mLSTM block (pre-LN residual):
    x -> up-proj to 2*inner (branches u, z)
    u -> causal conv -> q,k,v heads -> mLSTM cell -> per-head groupnorm
    y = down-proj( cell_out * silu(z) )

mLSTM cell with exponential gating and the stabilizer m (paper eq. 19-27):
    C_t = f' C_{t-1} + i' v k^T      n_t = f' n_{t-1} + i' k
    h_t = C_t q / max(|n_t . q|, 1)
    f' = exp(ftilde + m_{t-1} - m_t), i' = exp(itilde - m_t),
    m_t = max(ftilde + m_{t-1}, itilde)

Prefill and training run the chunkwise-parallel form (`mlstm_seq`); decode
is the one-step update. sLSTM cannot be parallelized over time (its h->h
recurrence is nonlinear) and runs a loop over the sequence, as the JAX
package's `lax.scan`.

Decode states are dicts, batch first: mLSTM {"C" [B,h,hd,hd], "n" [B,h,hd],
"m" [B,h], "conv" [B,K-1,inner]}, sLSTM {"c", "n", "m", "h"} each
[B,inner]. Everything but "conv" is fp32 whatever the weights' dtype;
"conv" takes the weights' dtype. (The JAX package keeps the same tensors
as tuples, in that order.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import aconstrain, merge_last, split_last
from repro_torch.models.layers import (causal_conv1d, checkpointed, dense_init,
                                       init_conv1d, init_layernorm, layernorm)

MLSTM_CHUNK = 256


def _inner(cfg):
    return int(cfg.d_model * cfg.proj_factor)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, dtype, device):
    d = cfg.d_model
    inner = _inner(cfg)
    h = cfg.num_heads
    hd = inner // h
    b_if = torch.cat([torch.zeros(h), torch.linspace(3.0, 6.0, h)])
    return {
        "w_up": dense_init(gen, d, inner, dtype, device),
        "w_z": dense_init(gen, d, inner, dtype, device),
        "conv": init_conv1d(gen, inner, cfg.conv_kernel, dtype, device),
        "wq": dense_init(gen, inner, inner, dtype, device),
        "wk": dense_init(gen, inner, inner, dtype, device),
        "wv": dense_init(gen, inner, inner, dtype, device),
        # gates are per-head scalars computed from the conv'd branch
        "w_if": dense_init(gen, inner, 2 * h, dtype, device),
        "b_if": b_if.to(device=device, dtype=dtype),
        "norm": init_layernorm(hd, dtype, device),
        "w_down": dense_init(gen, inner, d, dtype, device),
    }


def _mlstm_cell_step(state, q, k, v, it, ft):
    """One step. state: {"C" [B,h,hd,hd], "n" [B,h,hd], "m" [B,h]};
    q, k, v: [B,h,hd]; it, ft: [B,h]. Returns (new state, h_out [B,h,hd])."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ft + m, it)
    fp = torch.exp(ft + m - m_new)[..., None]             # [B,h,1]
    ip = torch.exp(it - m_new)[..., None]
    C = fp[..., None] * C + ip[..., None] * (v[..., :, None] * k[..., None, :])
    n = fp * n + ip * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    # stabilized normalizer max(|n.q|, exp(-m)) == unstabilized max(|n*.q|, 1)
    den = torch.maximum(torch.abs(torch.einsum("bhi,bhi->bh", n, q)),
                        torch.exp(-m_new))[..., None]
    return {"C": C, "n": n, "m": m_new}, num / den


def _mlstm_chunk(C_in, n_in, m_in, q_i, k_i, v_i, i_i, f_i):
    """One chunk of the chunkwise-parallel form: the state enters at the
    chunk's start, the output inside it is the stabilized quadratic form.
    C_in [B,H,hd,hd], n_in [B,H,hd], m_in [B,H]; q/k/v [B,c,H,hd];
    i/f [B,c,H]. Returns (h [B,c,H,hd], C_out, n_out, m_out)."""
    c = q_i.shape[1]
    Fc = torch.cumsum(f_i, dim=1)                          # inclusive log f sums
    c_s = i_i - Fc
    m_loc = torch.cummax(c_s, dim=1).values
    m_t = Fc + torch.maximum(m_in[:, None], m_loc)          # running max per step
    # intra-chunk stabilized decay d_ts = exp(F_t - F_s + i_s - m_t), masked
    # to s <= t before exp so the upper triangle never reaches it
    logd = Fc[:, :, None] - Fc[:, None, :] + i_i[:, None, :] - m_t[:, :, None]
    tri = torch.ones((c, c), dtype=torch.bool, device=q_i.device).tril()
    d = torch.exp(torch.where(tri[None, :, :, None], logd, -torch.inf))
    e_t = torch.exp(Fc + m_in[:, None] - m_t)              # inter-chunk scale

    s_qk = torch.einsum("bthd,bshd->bhts", q_i, k_i)
    w = s_qk * d.permute(0, 3, 1, 2)
    intra_num = torch.einsum("bhts,bshd->bthd", w, v_i)
    intra_den = w.sum(-1).permute(0, 2, 1)                 # [B,c,H]
    inter_num = torch.einsum("bhij,bthj->bthi", C_in, q_i) * e_t[..., None]
    inter_den = torch.einsum("bhj,bthj->bth", n_in, q_i) * e_t
    den = torch.maximum(torch.abs(inter_den + intra_den), torch.exp(-m_t))
    h = (inter_num + intra_num) / den[..., None]

    # chunk-end state, stabilized at m_out = m_t[last]
    m_out = m_t[:, -1]
    g_s = torch.exp(Fc[:, -1:] - Fc + i_i - m_out[:, None])        # [B,c,H]
    carry = torch.exp(Fc[:, -1] + m_in - m_out)
    C_out = (carry[..., None, None] * C_in
             + torch.einsum("bshd,bshe->bhde", g_s[..., None] * v_i, k_i))
    n_out = carry[..., None] * n_in + torch.einsum("bsh,bshd->bhd", g_s, k_i)
    return h, C_out, n_out, m_out


def mlstm_seq(q, k, v, it, ft, state, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM, exactly the recurrent cell up to rounding.

    The sequence is split into chunks; (C, n, m) crosses chunk boundaries
    and within a chunk the output is a dense [chunk x chunk] form, so no
    per-step state is stored for backward (each chunk is recomputed).

    q/k/v: [B,S,h,hd] (q, k pre-scaled); it/ft: [B,S,h] fp32 (ft = log f);
    state: {"C", "n", "m"}. Returns (h [B,S,h,hd], {"C", "n", "m"})."""
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        # padded steps: f = 1 (log f = 0), i = -1e30, so the state passes through
        it = F.pad(it, (0, 0, 0, pad), value=-1e30)
        ft = F.pad(ft, (0, 0, 0, pad), value=0.0)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for s0 in range(0, S + pad, chunk):
        sl = slice(s0, s0 + chunk)
        h, C, n, m = checkpointed(_mlstm_chunk, C, n, m, q[:, sl], k[:, sl],
                                  v[:, sl], it[:, sl], ft[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S], {"C": C, "n": n, "m": m}


def mlstm_block(p, x, cfg, state=None):
    """x: [B,S,d] -> (y, new_state). state: {"C","n","m","conv"} or None."""
    B, S, _ = x.shape
    inner = _inner(cfg)
    h = cfg.num_heads
    hd = p["norm"]["scale"].shape[0]
    u = aconstrain(x @ p["w_up"], ("batch", None, "model"))
    z = aconstrain(x @ p["w_z"], ("batch", None, "model"))
    uc, new_conv = causal_conv1d(p["conv"], F.silu(u),
                                 None if state is None else state["conv"])

    q = split_last(uc @ p["wq"], h, hd).float() * (hd ** -0.5)
    k = split_last(uc @ p["wk"], h, hd).float() * (hd ** -0.5)
    v = split_last(u @ p["wv"], h, hd).float()
    gates = autoshard.settle(uc @ p["w_if"], ("batch", None, None)).float() + p["b_if"].float()
    it, ft = gates[..., :h], F.logsigmoid(gates[..., h:])

    if state is None:
        cell = {"C": torch.zeros((B, h, hd, hd), dtype=torch.float32, device=x.device),
                "n": torch.zeros((B, h, hd), dtype=torch.float32, device=x.device),
                "m": torch.zeros((B, h), dtype=torch.float32, device=x.device)}
    else:
        cell = {key: state[key] for key in ("C", "n", "m")}

    run = _mlstm_decode if S == 1 and state is not None else mlstm_seq
    hs, cell = _mlstm_by_head(run, q, k, v, it, ft, cell)

    hs = layernorm(p["norm"], hs)                          # per-head groupnorm
    y = (merge_last(hs).to(x.dtype) * F.silu(z)) @ p["w_down"]
    return y, {**cell, "conv": new_conv}


def _mlstm_decode(q, k, v, it, ft, cell):
    """The one-step update of a decode token, as `mlstm_seq` returns it."""
    cell, h_out = _mlstm_cell_step(cell, q[:, 0], k[:, 0], v[:, 0], it[:, 0], ft[:, 0])
    return h_out[:, None], cell


def _mlstm_by_head(run, q, k, v, it, ft, cell):
    """run (`mlstm_seq` or `_mlstm_decode`); under an active DeviceMesh on
    local shards: batch over the data axes, heads over 'model' where they
    divide (the cell is independent per row and per head)."""
    pl4 = autoshard.placements(q.shape, ("batch", None, "model", None))
    pl3 = autoshard.placements(it.shape, ("batch", None, "model"))
    st = {key: autoshard.placements(cell[key].shape, ("batch", "model") + (None,) * (cell[key].ndim - 2))
          for key in ("C", "n", "m")}

    def cell_run(q, k, v, it, ft, C, n, m):
        hs, c = run(q, k, v, it, ft, {"C": C, "n": n, "m": m})
        return hs, c["C"], c["n"], c["m"]

    hs, C, n, m = autoshard.local(cell_run, (pl4, pl4, pl4, pl3, pl3, st["C"], st["n"], st["m"]),
                                  (pl4, st["C"], st["n"], st["m"]))(
        q, k, v, it, ft, cell["C"], cell["n"], cell["m"])
    return hs, {"C": C, "n": n, "m": m}


def init_mlstm_state(cfg, batch: int, dtype, device):
    inner = _inner(cfg)
    h = cfg.num_heads
    hd = inner // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.zeros((batch, h), **f32),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, inner), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, dtype, device):
    d = cfg.d_model
    inner = _inner(cfg)
    h = cfg.num_heads
    hd = inner // h
    r = torch.randn((4, h, hd, hd), generator=gen, device=device, dtype=torch.float32)
    b = torch.cat([torch.zeros(2 * inner), torch.linspace(3.0, 6.0, inner),
                   torch.zeros(inner)])
    # input projections for (z, i, f, o) and block-diagonal recurrent matrices
    return {
        "w_in": dense_init(gen, d, 4 * inner, dtype, device),
        "r": (r * (hd ** -0.5)).to(dtype),
        "b": b.to(device=device, dtype=dtype),
        "norm": init_layernorm(inner, dtype, device),
        "w_down": dense_init(gen, inner, d, dtype, device),
    }


def _slstm_step(r, state, pre):
    """One step on fp32 operands: r [4,h,hd,hd], pre = x_t + b [B,4*inner];
    state {"c","n","m","h"} each [B,inner]. Returns the new state."""
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    B = c.shape[0]
    nh, hd = r.shape[1], r.shape[-1]
    rec = torch.einsum("ghij,bhj->gbhi", r, h.reshape(B, nh, hd)).reshape(4, B, nh * hd)
    zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
    zt = torch.tanh(zt + rec[0])
    it = it + rec[1]
    ft = F.logsigmoid(ft + rec[2])
    ot = torch.sigmoid(ot + rec[3])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    # torch.maximum splits the gradient at n == 1 (the first step from zeros)
    # as jnp.maximum does; clamp would give it all to n
    return {"c": c, "n": n, "m": m_new, "h": ot * c / torch.maximum(n, torch.ones_like(n))}


def slstm_block(p, x, cfg, state=None):
    """x: [B,S,d] -> (y, new_state). A loop over S: the fp32 recurrent
    matrices and the biased inputs are made once, outside it."""
    B, S, _ = x.shape
    xin = aconstrain(x @ p["w_in"], ("batch", None, "model"))
    if state is None:
        state = init_slstm_state(cfg, B, x.dtype, x.device)
    r = p["r"].float()
    pre = xin.float() + p["b"].float()
    hs, state = _slstm_scan(r, pre, state, p["norm"])
    return hs.to(x.dtype) @ p["w_down"], state


def _slstm_loop(r, pre, c, n, m, h, scale, bias):
    state = {"c": c, "n": n, "m": m, "h": h}
    hs = []
    for t in range(pre.shape[1]):
        state = _slstm_step(r, state, pre[:, t])
        hs.append(state["h"])
    hs = layernorm({"scale": scale, "bias": bias}, torch.stack(hs, dim=1))
    return (hs,) + tuple(state[key] for key in ("c", "n", "m", "h"))


def _slstm_scan(r, pre, state, norm):
    """The loop over S and the layernorm of its outputs: (normed h [B,S,
    inner], new state). Under an active DeviceMesh on local shards, batch
    over the data axes; the h->h recurrence mixes each head's width, so the
    width is whole. The layernorm runs in the same region: outside it, the
    gradient of its input would meet a pending sum over 'data' split over
    'model' and a batch split, which torch 2.11's DTensor cannot add."""
    keys = ("c", "n", "m", "h")
    rep = autoshard.placements(r.shape, (None,) * r.ndim)
    vec = autoshard.placements(norm["scale"].shape, (None,))
    seq = autoshard.placements(pre.shape, ("batch", None, None))
    row = autoshard.placements(state["c"].shape, ("batch", None))
    out = autoshard.local(_slstm_loop, (rep, seq) + (row,) * 4 + (vec, vec),
                          (seq,) + (row,) * 4)(
        r, pre, *(state[key] for key in keys), norm["scale"], norm["bias"])
    return out[0], dict(zip(keys, out[1:]))


def init_slstm_state(cfg, batch: int, dtype, device):
    """Four fp32 zeros [batch, inner]; `dtype` is unused, as in the JAX
    package (the sLSTM state has no conv)."""
    inner = _inner(cfg)
    return {key: torch.zeros((batch, inner), dtype=torch.float32, device=device)
            for key in ("c", "n", "m", "h")}
