"""Flash attention: the wrapper around the CUDA kernel of
`csrc/flash_attention.cu`, which replaces the Pallas TPU kernel
`repro.kernels.flash_attention.flash_attention`.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in `ref.py`. `flash_attention.launches` counts wrapper calls that
launched the kernel. The path is chosen by dtype and shape alone:

* Sq < DECODE_MAX_SQ (decode): split-KV, two launches (the splits' partials,
  then their merge), one where the plan has one split; `decode_splits`
  plans the splits from the decode blocks the card holds at once (asked of
  the card once per dtype and head dim) and the wrapper allocates the
  partials' scratch.
* bf16, Sq >= DECODE_MAX_SQ, hd in WGMMA_HEAD_DIMS (prefill): wgmma fed by
  TMA, skipping kv tiles that the mask empties (`prefill_tile_classes` is
  the plain twin of the hd-64 kernel's classes); two launches (the mean of
  V, for rows with no valid slot, and at hd 64 the kv slots' position
  summaries; then the attention).
* otherwise (fp32 prefill, bf16 at hd 32): CUDA cores, one launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_SQ = 64
SPLIT_KEYS = 64          # decode splits are dealt whole tiles of this many keys
MAX_SPLITS = 256         # kMaxSplits of the combine kernel
# decode blocks an H100 holds at once (132 SMs x 1 of the hd-64 and hd-256
# bf16 blocks): the plan's default; the wrapper asks the card for its own
# count
RESIDENT_DECODE_BLOCKS = 132
PREFILL_BLOCK_Q = 128    # query rows of a prefill block
PREFILL64_KEYS = 128     # keys of a kv tile of the hd-64 prefill
SUMMARY_KEYS = 64        # kv slots one position summary covers
MEAN_SPLITS_64 = 8       # key ranges the hd-64 prefill's mean of V is summed over
DEAD, PARTIAL, FULL = 0, 1, 2


def decode_rows(dtype) -> int:
    """Query rows one decode block holds: an mma M tile in bf16, 8 in fp32."""
    return 16 if dtype == torch.bfloat16 else 8


def decode_splits(B: int, Sq: int, nq: int, nkv: int, Skv: int, dtype,
                  resident: int = RESIDENT_DECODE_BLOCKS) -> int:
    """Splits of a decode call's kv range: as many as keep the grid of B x
    nkv x row tiles x splits blocks within the `resident` blocks the card
    holds at once (so every block is in flight from the start), at most
    MAX_SPLITS and one per SPLIT_KEYS tile. The tiles are dealt evenly
    (`decode_split_range`)."""
    tiles = math.ceil(Skv / SPLIT_KEYS)
    units = B * nkv * math.ceil(nq // nkv * Sq / decode_rows(dtype))
    return max(1, min(MAX_SPLITS, tiles, resident // units))


def decode_split_range(i: int, splits: int, Skv: int) -> tuple[int, int]:
    """Keys [k0, k1) of split i, as the kernel computes them: split i takes
    SPLIT_KEYS tiles [i * tiles // splits, (i + 1) * tiles // splits)."""
    tiles = math.ceil(Skv / SPLIT_KEYS)
    return (i * tiles // splits * SPLIT_KEYS,
            min(Skv, (i + 1) * tiles // splits * SPLIT_KEYS))


@functools.cache
def _resident_decode_blocks(device_index: int, dtype, hd: int) -> int:
    """Decode blocks of this dtype and head dim the card holds at once: its
    SMs times the kernel's occupancy."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = build.load().repro_flash_decode_blocks_per_sm(_DTYPE_CODE[dtype], hd,
                                                            ctypes.byref(blocks))
    if err or blocks.value <= 0:
        raise RuntimeError(f"flash decode occupancy query failed: cudaError {err}")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * blocks.value


def prefill_tile_classes(q_pos, kv_pos, *, causal: bool = True,
                         window: Optional[int] = None, block_q: int = PREFILL_BLOCK_Q,
                         block_k: int = PREFILL64_KEYS):
    """The plain twin of the hd-64 prefill's tile classes: [B, query blocks,
    kv tiles] of DEAD (no (row, key) pair of the block can be valid), FULL
    (every pair is) or PARTIAL, from the block's q_pos min and max and the
    tile's kv_pos summaries (lowest and highest position held; whether every
    slot below Skv holds one), as the kernel decides them: conservative, as
    positions are arbitrary ring-buffer slots. q_pos [B, Sq], kv_pos [B, Skv]
    int32 (-1 = empty)."""
    B, Sq = q_pos.shape
    Skv = kv_pos.shape[1]
    n_q, n_k = math.ceil(Sq / block_q), math.ceil(Skv / block_k)
    big = torch.iinfo(torch.int32).max
    out = torch.zeros((B, n_q, n_k), dtype=torch.int64)
    pad = n_k * block_k - Skv
    kp = torch.nn.functional.pad(kv_pos.long(), (0, pad), value=-1).reshape(B, n_k, block_k)
    held = kp >= 0
    lo = torch.where(held, kp, torch.full_like(kp, big)).amin(-1)
    hi = torch.where(held, kp, torch.full_like(kp, -big - 1)).amax(-1)
    every = held.all(-1)                                   # [B, n_k]; slots past Skv hold none
    for j in range(n_q):
        rows = q_pos[:, j * block_q:(j + 1) * block_q].long()
        qmin, qmax = rows.amin(-1, keepdim=True), rows.amax(-1, keepdim=True)
        live, full = lo <= hi, every & ((j + 1) * block_q <= Sq)
        if causal:
            live = live & (lo <= qmax)
            full = full & (hi <= qmin)
            if window is not None:
                live = live & (hi > qmin - window)
                full = full & (qmax - lo < window)
        out[:, j] = torch.where(live, torch.where(full, FULL, PARTIAL), DEAD)
    return out


def _scratch(dtype, B, Sq, Skv, nq, nkv, hd, device) -> tuple[int, int]:
    """(decode splits or 0, fp32 scratch elements) of the path this call takes."""
    if Sq < DECODE_MAX_SQ:
        splits = decode_splits(B, Sq, nq, nkv, Skv, dtype,
                               _resident_decode_blocks(device.index, dtype, hd))
        return splits, B * nkv * (nq // nkv * Sq) * splits * (hd + 2)
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        if hd == 64:
            return 0, B * nkv * MEAN_SPLITS_64 * hd + 3 * B * math.ceil(Skv / SUMMARY_KEYS)
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
    splits, n_scratch = _scratch(q.dtype, B, Sq, Skv, nq, nkv, hd, q.device)
    out = torch.empty_like(q)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.load().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Skv, nq, nkv, hd, int(causal),
            window or 0, float(softcap or 0.0), splits, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
