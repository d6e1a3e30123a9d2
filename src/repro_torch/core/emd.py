"""EMD data-heterogeneity metric and the GenFV weighted policy
(paper Sec. III-C1, eq. 3-4).

EMD_n = sum_i | p_n(y=i) - p(y=i) |     (global reference p = uniform 1/Y)
kappa2 = (EMD_bar / 2)^2,  kappa1 = 1 - kappa2
omega^t = kappa1 * sum_n rho_n omega_n + kappa2 * omega_a

The host half (histograms, EMDs, kappas, data weights) is a copy of the JAX
package's numpy code and agrees with it bit for bit. The device half is
eq. 4 over the flat parameter buffers of the fleet engine (fl/fleet.py),
`aggregate_stacked_guarded`, and over parameter trees: `aggregate` (the
sequential path's eq. 4) and `add_weighted` (the stale merge). Each is the
JAX function's float32 arithmetic in the JAX function's order, so on the
CPU it gives the JAX package's bits.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.tree import FlatSpec, tree_leaves


def label_histogram(labels, num_classes: int) -> np.ndarray:
    """Normalized label distribution p_n(y=i) of one client's dataset."""
    labels = np.asarray(labels)
    h = np.bincount(labels, minlength=num_classes).astype(np.float64)
    return h / max(h.sum(), 1.0)


def emd(p_n: np.ndarray, p_global: np.ndarray | None = None) -> float:
    """EMD_n = sum_i |p_n(i) - p(i)|; p defaults to uniform (paper Sec. III-C1).

    Range [0, 2): 0 = IID, -> 2(Y-1)/Y for a single-class client.
    """
    p_n = np.asarray(p_n, np.float64)
    if p_global is None:
        p_global = np.full_like(p_n, 1.0 / p_n.shape[-1])
    return float(np.abs(p_n - p_global).sum(-1))


def emd_many(hists: np.ndarray, p_global: np.ndarray | None = None) -> np.ndarray:
    hists = np.asarray(hists, np.float64)
    if p_global is None:
        p_global = np.full(hists.shape[-1], 1.0 / hists.shape[-1])
    return np.abs(hists - p_global).sum(-1)


def mean_emd(emds: Sequence[float]) -> float:
    """EMD_bar over the participating set (paper: average data quality)."""
    emds = np.asarray(list(emds), np.float64)
    return float(emds.mean()) if emds.size else 0.0


def kappas(emd_bar: float) -> tuple[float, float]:
    """(kappa1, kappa2) from eq. (4): kappa2 = (EMD_bar/2)^2 clipped to [0,1]."""
    k2 = min(max((emd_bar / 2.0) ** 2, 0.0), 1.0)
    return 1.0 - k2, k2


def data_weights(sizes: Sequence[int]) -> np.ndarray:
    """rho_n = |D_n| / sum |D_n| over the selected set."""
    sizes = np.asarray(list(sizes), np.float64)
    return sizes / max(sizes.sum(), 1.0)


def _f32(x) -> float:
    """A host weight as the float32 value JAX multiplies by (a Python float
    meets a float32 array as float32)."""
    return float(np.float32(x))


def aggregate(models: Sequence, rhos: Sequence[float], aug_model,
              emd_bar: float):
    """Eq. (4) over parameter trees, the sequential path's host loop:
    omega = kappa1 * sum rho_n omega_n + kappa2 * omega_a, the sum taken in
    list order from 0 (Python's `sum`), in float32."""
    k1, k2 = kappas(emd_bar)
    rhos = np.asarray(list(rhos), np.float64)
    spec = FlatSpec(aug_model)
    flats = [spec.flatten(m) for m in models]
    fed = sum(_f32(r) * f.float() for r, f in zip(rhos, flats))
    out = _f32(k1) * fed + _f32(k2) * spec.flatten(aug_model).float()
    return spec.unflatten(out.to(flats[0].dtype))


def add_weighted(params, models: Sequence, weights: Sequence[float]):
    """params + sum_i w_i * m_i, accumulated in float32 in list order: the
    staleness-discounted merge of buffered late updates into an aggregated
    global (fl/rounds.py)."""
    if not models:
        return params
    spec = FlatSpec(params)
    p = spec.flatten(params)
    acc = p.float()
    for w, m in zip(weights, models):
        acc = acc + _f32(w) * spec.flatten(m).float()
    return spec.unflatten(acc.to(p.dtype))


def tree_finite(tree) -> bool:
    """Every leaf of the tree is finite (the sequential path's poison
    filter; reads the values on the host)."""
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def aggregate_stacked_guarded(stacked: torch.Tensor, weights: Sequence[float],
                              aug: torch.Tensor, aug_weight: float,
                              fallback: torch.Tensor):
    """Eq. (4) on the device over flat parameter buffers, with a
    per-client finiteness guard. `stacked` [K, P] holds the K clients'
    models, `weights` [K] are kappa1 * rho_n (zero on padded slots, float32
    values), `aug` [P] is omega_a and `aug_weight` kappa2. Rows holding a
    NaN or Inf are left out of the federated term and the surviving weights
    renormalised, so the federated mass (the sum of `weights`) stays what
    it was; if every row is rejected the federated mass goes to `fallback`
    [P] (the round-start global). Accumulates in float32, as the JAX
    package does, and returns (aggregate [P] in `stacked`'s dtype,
    finite [K] bool), both on `stacked`'s device, without a host read.

    The JAX package's `aggregate_stacked_guarded` step for step:
    w = weights * finite, s_all and s_fin float32 sums (left to right,
    which is XLA:CPU's order for K <= 32; padded slots add exact zeros),
    scale = s_all / s_fin, then the fixed left-to-right chain
    `fed = w0*s0; fed = fed + wi*si; ...` with each row selected by
    `torch.where` before its multiply (0 * NaN is NaN, so the mask is never
    multiplied in). `torch.sum` and `einsum` promise no order, so the chain
    is written out: zero-weight padded slots add exact zeros and the
    aggregate does not depend on the bucket the fleet was padded to. On
    finite rows s_fin == s_all, scale is exactly 1.0 and the result is the
    bits of the JAX package's unguarded `aggregate_stacked`."""
    if stacked.dim() != 2 or stacked.shape[0] != len(weights):
        raise ValueError(f"stacked {tuple(stacked.shape)} against "
                         f"{len(weights)} weights")
    s32 = stacked.float()
    finite = torch.isfinite(s32).all(dim=1)
    wt = torch.tensor(np.asarray(weights, np.float32), device=stacked.device)
    w = wt * finite
    s_all, s_fin = wt[0], w[0]
    for i in range(1, len(weights)):
        s_all = s_all + wt[i]
        s_fin = s_fin + w[i]
    zero = torch.zeros((), dtype=torch.float32, device=stacked.device)
    kept = s_fin > 0
    scale = torch.where(kept, s_all / s_fin, zero)
    fed = w[0] * torch.where(finite[0], s32[0], zero)
    for i in range(1, len(weights)):
        fed = fed + w[i] * torch.where(finite[i], s32[i], zero)
    fed = torch.where(kept, fed * scale, s_all * fallback.float())
    out = fed + _f32(aug_weight) * aug.float()
    return out.to(stacked.dtype), finite
