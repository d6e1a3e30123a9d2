"""The port's kernel wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from fixed seeds and fed to both packages. The
Pallas kernels run in interpret mode on the CPU, as in tests/test_kernels.py;
the port's wrappers take their plain PyTorch versions for CPU tensors (the
CUDA kernels themselves are checked on the card by chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.rglru_scan import rglru_scan as pallas_scan
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (SPLIT_KEYS, TARGET_BLOCKS,
                                                 decode_rows, decode_splits)
from repro_torch.kernels.rglru_scan import MIN_CHUNK, TARGET_LANES, scan_chunks


def _attn_inputs(rng, B, Sq, Skv, nq, nkv, hd):
    q = rng.normal(size=(B, Sq, nq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, nkv, hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, q_pos, kv_pos, **kw):
    """(Pallas output, port output) as numpy, on the same inputs."""
    bq = kw.pop("block_q", 128)
    bk = kw.pop("block_k", 128)
    want = pallas_flash(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                        block_q=bq, block_k=bk, **kw)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)), **kw)
    assert ops.flash_attention.launches == launches   # CPU: no kernel launch
    assert got.dtype == torch.float32
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_pallas(case):
    Sq, Skv, nq, nkv, hd, win, cap, bq, bk = case
    rng = np.random.default_rng(hash(case) % 2 ** 31)
    q, k, v = _attn_inputs(rng, 2, Sq, Skv, nq, nkv, hd)
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)[None].repeat(2, 0)
    kv_pos = np.arange(Skv, dtype=np.int32)[None].repeat(2, 0)
    want, got = _both(q, k, v, q_pos, kv_pos, window=win, softcap=cap,
                      block_q=bq, block_k=bk)
    assert got.shape == want.shape == (2, Sq, nq, hd)
    assert np.abs(got - want).max() < 2e-6


@pytest.mark.parametrize("empty_slots", [0, 16])
def test_fully_masked_rows_match_pallas(empty_slots):
    """A prefill longer than the window attends to the last Skv = 128 cached
    keys only, so its first query rows have no valid slot. Pallas (Skv a
    multiple of its block) and the port both average V uniformly over the
    Skv real slots there; empty slots (pos -1) count among them."""
    rng = np.random.default_rng(7)
    Sq, Skv = 160, 128
    q, k, v = _attn_inputs(rng, 1, Sq, Skv, 4, 1, 64)
    q_pos = np.arange(Sq, dtype=np.int32)[None]
    kv_pos = np.arange(Sq - Skv, Sq, dtype=np.int32)[None]
    kv_pos[:, :empty_slots] = -1
    want, got = _both(q, k, v, q_pos, kv_pos, window=64)
    first_valid = Sq - Skv + empty_slots
    np.testing.assert_allclose(got[0, :first_valid],
                               np.broadcast_to(v[0].mean(0), (first_valid, 4, 64)),
                               atol=2e-6)
    assert np.abs(got - want).max() < 2e-6


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 100, 70), (3, 17, 5),
                                   (2, 256, 128)])
def test_rglru_scan_matches_pallas(shape):
    rng = np.random.default_rng(int(np.prod(shape)))
    la = (-np.abs(rng.normal(size=shape))).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(pallas_scan(jnp.asarray(la), jnp.asarray(b),
                                  block_t=16, block_w=16))
    launches = ops.rglru_scan.launches
    got = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(b)).numpy()
    assert ops.rglru_scan.launches == launches
    assert np.abs(got - want).max() < 1e-5


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 4, 2, 32)
    kv = torch.zeros(1, 8, 1, 32)
    qp = torch.arange(4, dtype=torch.int32)[None]
    kp = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), kv.half(), kv.half(), qp, kp)
    with pytest.raises(TypeError):
        ops.flash_attention(q, kv, kv, qp.long(), kp.long())
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv, qp, kp[:, :4])
    with pytest.raises(ValueError):
        ops.flash_attention(q, kv, kv, qp, kp, window=0)
    with pytest.raises(TypeError):
        ops.rglru_scan(torch.zeros(1, 4, 8).double(), torch.zeros(1, 4, 8).double())
    with pytest.raises(ValueError):
        ops.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 9))


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device gets the
    kernel or an error, never a silent fallback."""
    q = torch.zeros(1, 4, 2, 32, device="meta")
    kv = torch.zeros(1, 8, 1, 32, device="meta")
    qp = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    kp = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, kv, kv, qp, kp)
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru_scan(torch.zeros(1, 4, 8, device="meta"),
                       torch.zeros(1, 4, 8, device="meta"))


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    la = (-np.abs(rng.normal(size=shape))).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    h0 = (3.0 * rng.normal(size=(shape[0], shape[2]))).astype(np.float32)
    return la, b, h0


@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 100, 70), (3, 17, 5),
                                   (2, 256, 128), (1, 2500, 64)])
def test_rglru_scan_h0_matches_pallas_fold_in(shape):
    """The scan from an incoming state equals the reference's Pallas scan
    from zero plus its fold-in, h_t += exp(cumsum(log_a))_t h0
    (src/repro/models/rglru.py). The two sum log_a in different orders, so
    the limit is relative: 1e-5 x max(1, |ref|)."""
    la, b, h0 = _scan_inputs(shape, int(np.prod(shape)) + 1)
    la_j = jnp.asarray(la)
    zero = pallas_scan(la_j, jnp.asarray(b), block_t=min(256, shape[1]),
                       block_w=min(64, shape[2]))
    want = np.asarray(zero + jnp.exp(jnp.cumsum(la_j, axis=1)) * jnp.asarray(h0)[:, None])
    launches = ops.rglru_scan.launches
    got = ops.rglru_scan(*map(torch.from_numpy, (la, b, h0))).numpy()
    assert ops.rglru_scan.launches == launches
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))


def test_rglru_scan_without_h0_is_zero_h0():
    la, b, h0 = map(torch.from_numpy, _scan_inputs((2, 40, 24), 3))
    np.testing.assert_array_equal(ops.rglru_scan(la, b).numpy(),
                                  ops.rglru_scan(la, b, torch.zeros_like(h0)).numpy())


def test_rglru_scan_rejects_bad_h0():
    la, b = torch.zeros(2, 4, 8), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="h0 must be"):
        ops.rglru_scan(la, b, torch.zeros(2, 9))
    with pytest.raises(ValueError, match="h0 must be"):
        ops.rglru_scan(la, b, torch.zeros(2, 4, 8))
    with pytest.raises(TypeError, match="h0 must be float32"):
        ops.rglru_scan(la, b, torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        ops.rglru_scan(la, b, torch.zeros(2, 8, device="meta"))


@pytest.mark.parametrize("B,S,W", [(1, 2500, 4096), (3, 17, 5), (2, 257, 4100),
                                   (2, 1, 64), (64, 4096, 4096), (1, 100000, 8)])
def test_scan_chunks_cover_steps(B, S, W):
    """The chunks tile S exactly, the last one non-empty, each at least
    MIN_CHUNK steps unless S is shorter, and enough of them to fill the
    card where S allows."""
    chunk, n = scan_chunks(B, S, W)
    assert chunk * (n - 1) < S <= chunk * n
    assert chunk >= min(S, MIN_CHUNK)
    if S >= MIN_CHUNK * TARGET_LANES / (B * W):
        assert B * W * n >= TARGET_LANES


@pytest.mark.parametrize("B,Sq,nq,nkv,Skv,dtype", [
    (4, 1, 16, 1, 2048, torch.bfloat16), (4, 1, 16, 1, 2000, torch.float32),
    (1, 1, 16, 1, 2048, torch.bfloat16), (2, 33, 6, 3, 65, torch.float32),
    (2, 50, 8, 2, 130, torch.bfloat16), (4, 1, 4, 4, 130, torch.bfloat16),
    (64, 1, 32, 8, 32768, torch.bfloat16), (1, 1, 8, 8, 1, torch.float32)])
def test_decode_splits_cover_keys(B, Sq, nq, nkv, Skv, dtype):
    """Split i covers keys [i * keys, min(Skv, (i + 1) * keys)): the splits
    cover [0, Skv) once, none is empty, each is a whole number of
    SPLIT_KEYS tiles, and the grid stays near one block per SM unless the
    (batch, kv head, row tile) blocks alone exceed it."""
    keys, splits = decode_splits(B, Sq, nq, nkv, Skv, dtype)
    assert keys % SPLIT_KEYS == 0
    assert keys * (splits - 1) < Skv <= keys * splits
    covered = np.zeros(Skv, dtype=int)
    for i in range(splits):
        covered[i * keys:min(Skv, (i + 1) * keys)] += 1
    assert np.all(covered == 1)
    base = B * nkv * -(-(nq // nkv * Sq) // decode_rows(dtype))
    assert base * splits <= max(TARGET_BLOCKS, base) + base
    if keys > SPLIT_KEYS:
        assert base * -(-Skv // (keys - SPLIT_KEYS)) > TARGET_BLOCKS
