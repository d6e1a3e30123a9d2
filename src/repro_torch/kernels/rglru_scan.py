"""RG-LRU scan: the wrapper around the CUDA kernel of `csrc/rglru_scan.cu`,
which replaces the Pallas TPU kernel `repro.kernels.rglru_scan.rglru_scan`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in `ref.py`. `rglru_scan.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref


def rglru_scan(log_a, b):
    """log_a, b: [B, S, W] fp32 -> h: [B, S, W] fp32 (h_0 prior = 0)."""
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"log_a and b must both be [B,S,W]; got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"log_a and b must be float32; got {log_a.dtype}, {b.dtype}")
    if log_a.device != b.device:
        raise ValueError("log_a and b must lie on one device")
    if log_a.device.type == "cpu":
        return rglru_scan_ref(log_a, b)
    if log_a.device.type != "cuda":
        raise ValueError(f"no kernel for device {log_a.device}")
    if not (log_a.is_contiguous() and b.is_contiguous()):
        raise ValueError("log_a and b must be contiguous")
    B, S, W = log_a.shape
    h = torch.empty_like(b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.load().repro_rglru_scan(log_a.data_ptr(), b.data_ptr(),
                                            h.data_ptr(), B, S, W, stream)
    if err:
        raise RuntimeError(f"rglru scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
