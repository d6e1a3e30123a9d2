"""EMD data-heterogeneity metric and the GenFV weighted policy
(paper Sec. III-C1, eq. 3-4).

EMD_n = sum_i | p_n(y=i) - p(y=i) |     (global reference p = uniform 1/Y)
kappa2 = (EMD_bar / 2)^2,  kappa1 = 1 - kappa2
omega^t = kappa1 * sum_n rho_n omega_n + kappa2 * omega_a

The host half (histograms, EMDs, kappas, data weights) is a copy of the JAX
package's numpy code and agrees with it bit for bit. The device half,
`aggregate_stacked`, is eq. 4 over the flat parameter buffers of the fleet
engine (fl/fleet.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


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


def aggregate_stacked(stacked: torch.Tensor, weights: Sequence[float],
                      aug: torch.Tensor, aug_weight: float) -> torch.Tensor:
    """Eq. (4) on the device over flat parameter buffers: `stacked` [K, P]
    holds the K clients' models, `weights` [K] are kappa1 * rho_n (zero on
    padded slots, float32 values), `aug` [P] is omega_a and `aug_weight`
    kappa2. Accumulates in float32, as the JAX package does, and returns
    the [P] aggregate in `stacked`'s dtype.

    The weighted sum is the fixed left-to-right chain of the JAX package's
    `aggregate_stacked`, `fed = w0*s0; fed = fed + wi*si; ...`, one multiply
    and one add per client over the whole buffer (2K elementwise launches
    a round). `torch.sum` and `einsum` promise no order, so the chain is
    written out: zero-weight padded slots then add exact zeros, and the
    aggregate does not depend on the bucket the fleet was padded to.
    """
    if stacked.dim() != 2 or stacked.shape[0] != len(weights):
        raise ValueError(f"stacked {tuple(stacked.shape)} against "
                         f"{len(weights)} weights")
    s32 = stacked.float()
    ws = [float(np.float32(w)) for w in weights]
    fed = ws[0] * s32[0]
    for i in range(1, len(ws)):
        fed = fed + ws[i] * s32[i]
    out = fed + float(np.float32(aug_weight)) * aug.float()
    return out.to(stacked.dtype)
