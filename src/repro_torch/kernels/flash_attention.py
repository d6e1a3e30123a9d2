"""Flash attention: the wrapper around the CUDA kernel of
`csrc/flash_attention.cu`, which replaces the Pallas TPU kernel
`repro.kernels.flash_attention.flash_attention`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in `ref.py`. `flash_attention.launches` counts wrapper calls that
launched the kernel. The path is chosen by dtype and shape alone:

* Sq < DECODE_MAX_SQ (decode): split-KV, two launches (the splits' partials,
  then their merge); `decode_splits` plans the splits and the wrapper
  allocates the partials' scratch.
* bf16, Sq >= DECODE_MAX_SQ, hd in WGMMA_HEAD_DIMS (prefill): wgmma fed by
  TMA, skipping kv tiles that the mask empties; two launches (the mean of V,
  for rows with no valid slot, then the attention).
* otherwise (fp32 prefill, bf16 at hd 32): CUDA cores, one launch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_SQ = 64
SPLIT_KEYS = 64          # a decode split covers a multiple of this many keys
TARGET_BLOCKS = 132      # one block per SM of an H100


def decode_rows(dtype) -> int:
    """Query rows one decode block holds: an mma M tile in bf16, 8 in fp32."""
    return 16 if dtype == torch.bfloat16 else 8


def decode_splits(B: int, Sq: int, nq: int, nkv: int, Skv: int, dtype) -> tuple[int, int]:
    """(keys per split, split count) of a decode call: splits of a multiple
    of SPLIT_KEYS keys, as many as keep the grid of B x nkv x row tiles x
    splits blocks within about TARGET_BLOCKS; split i covers keys
    [i * keys, min(Skv, (i + 1) * keys)), every one non-empty."""
    tiles = math.ceil(Skv / SPLIT_KEYS)
    row_tiles = math.ceil(nq // nkv * Sq / decode_rows(dtype))
    per = max(1, math.ceil(tiles * B * nkv * row_tiles / TARGET_BLOCKS))
    keys = SPLIT_KEYS * per
    return keys, math.ceil(Skv / keys)


def _scratch(dtype, B, Sq, Skv, nq, nkv, hd) -> tuple[int, int]:
    """(keys per split or 0, fp32 scratch elements) of the path this call takes."""
    if Sq < DECODE_MAX_SQ:
        keys, splits = decode_splits(B, Sq, nq, nkv, Skv, dtype)
        return keys, B * nkv * (nq // nkv * Sq) * splits * (hd + 2)
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return 0, B * nkv * hd
    return 0, 0


def _check(q, k, v, q_pos, kv_pos, window, softcap):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,nq,hd] and k, v [B,Skv,nkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, nq, hd = q.shape
    _, Skv, nkv, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or nq % nkv:
        raise ValueError(f"mismatched q {tuple(q.shape)} and k {tuple(k.shape)}")
    if tuple(q_pos.shape) != (B, Sq) or tuple(kv_pos.shape) != (B, Skv):
        raise ValueError(f"positions must be [B,Sq] and [B,Skv]; got "
                         f"{tuple(q_pos.shape)}, {tuple(kv_pos.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if len({t.device for t in (q, k, v, q_pos, kv_pos)}) != 1:
        raise ValueError("q, k, v and positions must lie on one device")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: [B,Sq,nq,hd]; k,v: [B,Skv,nkv,hd]; q_pos: [B,Sq]; kv_pos: [B,Skv]
    (int32, -1 = empty slot). Returns [B,Sq,nq,hd] in q.dtype."""
    _check(q, k, v, q_pos, kv_pos, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, kv_pos)):
        raise ValueError("q, k, v and positions must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned (the kernel "
                         "copies 16-byte chunks)")
    keys_per_split, n_scratch = _scratch(q.dtype, B, Sq, Skv, nq, nkv, hd)
    out = torch.empty_like(q)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.load().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Skv, nq, nkv, hd, int(causal),
            window or 0, float(softcap or 0.0), keys_per_split, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
