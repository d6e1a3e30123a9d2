"""RG-LRU scan: the wrapper around the CUDA kernel of `csrc/rglru_scan.cu`,
which replaces the Pallas TPU kernel `repro.kernels.rglru_scan.rglru_scan`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in `ref.py`. `rglru_scan.launches` counts wrapper calls that
launched the kernel: one call is three launches on the stream (chunk
summaries, carries, chunk scans), or one when S fits a single chunk.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref

# Threads the chunked scan aims for: 2048 per SM of an H100's 132.
TARGET_LANES = 132 * 2048
MIN_CHUNK = 16


def scan_chunks(B: int, S: int, W: int) -> tuple[int, int]:
    """(chunk length, chunk count) of the chunked scan: enough chunks that
    B*W*chunks threads fill the card, each at least MIN_CHUNK steps long;
    the chunks cover S and the last one is non-empty."""
    n = max(1, min(math.ceil(TARGET_LANES / (B * W)), S // MIN_CHUNK))
    chunk = math.ceil(S / n)
    return chunk, math.ceil(S / chunk)


def rglru_scan(log_a, b, h0=None):
    """log_a, b: [B, S, W] fp32; h0: None (zeros) or the incoming state
    [B, W] fp32 -> h: [B, S, W] fp32 with h_t = exp(log_a_t) h_{t-1} + b_t."""
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"log_a and b must both be [B,S,W]; got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"log_a and b must be float32; got {log_a.dtype}, {b.dtype}")
    if log_a.device != b.device:
        raise ValueError("log_a and b must lie on one device")
    B, S, W = log_a.shape
    if h0 is not None:
        if tuple(h0.shape) != (B, W):
            raise ValueError(f"h0 must be [B,W] = {(B, W)}; got {tuple(h0.shape)}")
        if h0.dtype != torch.float32:
            raise TypeError(f"h0 must be float32; got {h0.dtype}")
        if h0.device != log_a.device:
            raise ValueError("h0 must lie on the device of log_a and b")
    if log_a.device.type == "cpu":
        return rglru_scan_ref(log_a, b, h0)
    if log_a.device.type != "cuda":
        raise ValueError(f"no kernel for device {log_a.device}")
    if not (log_a.is_contiguous() and b.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("log_a, b and h0 must be contiguous")
    chunk, n_chunks = scan_chunks(B, S, W)
    h = torch.empty_like(b)
    scratch = torch.empty(3 * B * n_chunks * W if n_chunks > 1 else 0,
                          dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.load().repro_rglru_scan(
            log_a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            h.data_ptr(), scratch.data_ptr(), B, S, W, chunk, n_chunks, stream)
    if err:
        raise RuntimeError(f"rglru scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
