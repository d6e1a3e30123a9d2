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
from repro_torch.kernels.flash_attention import (DEAD, FULL, MAX_SPLITS, PARTIAL,
                                                 RESIDENT_DECODE_BLOCKS, SPLIT_KEYS,
                                                 decode_rows, decode_split_range,
                                                 decode_splits, prefill_tile_classes)
from repro_torch.kernels.ref import flash_attention_ref
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
    (64, 1, 32, 8, 32768, torch.bfloat16), (1, 1, 8, 8, 1, torch.float32),
    (8, 1, 16, 16, 32768, torch.bfloat16), (8, 1, 16, 16, 32767, torch.bfloat16),
    (4, 1, 16, 16, 1000, torch.bfloat16), (128, 1, 16, 1, 2048, torch.bfloat16),
    (1, 1, 4, 4, 1_000_000, torch.bfloat16)])
def test_decode_splits_cover_keys(B, Sq, nq, nkv, Skv, dtype):
    """The splits cover [0, Skv) once, none is empty, each is dealt whole
    SPLIT_KEYS tiles and their tile counts differ by at most one (only the
    last is cut, by the ragged end of Skv), there are at most MAX_SPLITS (the
    combine kernel's kMaxSplits), and as many as keep the grid of (batch, kv
    head, row tile) blocks x splits within the blocks the card holds at
    once, unless those blocks alone exceed it. The L2 decode shape (batch 8,
    16 kv heads over 32768 slots) fills at least 0.95 of them: the hd-64
    block holds 128 KB of K/V in flight, one an SM (PERF.md, PR 21)."""
    splits = decode_splits(B, Sq, nq, nkv, Skv, dtype)
    assert 1 <= splits <= MAX_SPLITS
    ranges = [decode_split_range(i, splits, Skv) for i in range(splits)]
    covered = np.zeros(Skv, dtype=int)
    for k0, k1 in ranges:
        assert k0 < k1 and k0 % SPLIT_KEYS == 0
        covered[k0:k1] += 1
    assert np.all(covered == 1)
    assert all(k1 % SPLIT_KEYS == 0 for _, k1 in ranges[:-1]) and ranges[-1][1] == Skv
    tiles = [-(-k1 // SPLIT_KEYS) - k0 // SPLIT_KEYS for k0, k1 in ranges]
    assert max(tiles) - min(tiles) <= 1
    units = B * nkv * -(-(nq // nkv * Sq) // decode_rows(dtype))
    assert units * splits <= max(RESIDENT_DECODE_BLOCKS, units)
    assert (splits == min(MAX_SPLITS, -(-Skv // SPLIT_KEYS))
            or units * (splits + 1) > RESIDENT_DECODE_BLOCKS)
    if (B, Sq, nq, nkv, Skv) == (8, 1, 16, 16, 32768):
        assert units * splits >= 0.95 * RESIDENT_DECODE_BLOCKS


def _mask_from_ref(q_pos, kv_pos, causal, window):
    """[B, Sq, Skv] bool: which (query, key) pairs flash_attention_ref lets
    through, read from its output: zero q and k (every valid score 0), V the
    identity over the slots plus one always-empty slot (the head dim is the
    slot count), so a row's output is its softmax weights; a row with no
    valid slot spreads over the extra slot too, and counts as all masked."""
    B, Sq = q_pos.shape
    Skv = kv_pos.shape[1]
    kv = torch.cat([kv_pos, torch.full((B, 1), -1, dtype=torch.int32)], 1)
    eye = torch.eye(Skv + 1).expand(B, Skv + 1, Skv + 1)[:, :, None]
    p = flash_attention_ref(torch.zeros(B, Sq, 1, Skv + 1), torch.zeros_like(eye), eye,
                            q_pos, kv, causal=causal, window=window)[:, :, 0]
    return (p[..., :Skv] > 0) & (p[..., Skv:] == 0)


def _positions(kind, rng):
    """(q_pos, kv_pos, causal, window) of one seeded case."""
    if kind == "prefix":
        S = int(rng.integers(300, 700))
        pos = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
        return pos, pos.copy(), True, None
    if kind == "ring":
        cap, n = 384, int(rng.integers(800, 1200))
        q = np.arange(n - 500, n, dtype=np.int32)[None]
        kv = np.full((1, cap), -1, dtype=np.int32)
        p = np.arange(n - cap, n)
        kv[0, p % cap] = p
        return q, kv, True, int(rng.integers(100, 300))
    if kind == "windowed":
        S = int(rng.integers(500, 900))
        pos = np.arange(S, dtype=np.int32)[None]
        return pos, pos.copy(), True, int(rng.integers(300, 600))   # room for FULL tiles
    if kind == "empty slots":
        S = int(rng.integers(500, 800))
        q = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
        kv = q.copy()
        kv[rng.random(kv.shape) < 0.05] = -1
        kv[1, 256:384] = -1
        return q, kv, True, None
    S = 1500                                            # whisper's frames, non-causal
    q = np.arange(S, dtype=np.int32)[None].repeat(2, 0)
    kv = q.copy()
    kv[1, 1400:] = -1
    kv[0, 200:260:3] = -1
    return q, kv, False, None


@pytest.mark.parametrize("kind", ["prefix", "ring", "windowed", "empty slots", "non-causal"])
def test_prefill_tile_classes_hold_the_mask(kind):
    """The plain twin of the hd-64 prefill's tile classes against
    flash_attention_ref's mask on seeded positions: in a FULL tile every
    (row, key) pair of the block is valid, in a DEAD tile none is. On a
    causal prefix prompt every tile below a block's diagonal is FULL and
    the diagonal tile PARTIAL, so the mask is applied to one tile in a
    block's row."""
    rng = np.random.default_rng(["prefix", "ring", "windowed", "empty slots",
                                 "non-causal"].index(kind) + 31)
    q_pos, kv_pos, causal, window = _positions(kind, rng)
    q_pos, kv_pos = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    classes = prefill_tile_classes(q_pos, kv_pos, causal=causal, window=window)
    valid = _mask_from_ref(q_pos, kv_pos, causal, window)
    bq, bk = 128, 128
    seen = set()
    for b in range(classes.shape[0]):
        for i in range(classes.shape[1]):
            for j in range(classes.shape[2]):
                block = valid[b, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
                c = int(classes[b, i, j])
                seen.add(c)
                if c == FULL:
                    assert block.shape == (bq, bk) and bool(block.all()), (b, i, j)
                elif c == DEAD:
                    assert not bool(block.any()), (b, i, j)
    assert PARTIAL in seen
    if kind == "prefix":
        n_q = classes.shape[1]
        want = torch.full(classes.shape[1:], DEAD)
        for i in range(n_q):
            want[i, :i] = FULL
            want[i, i] = PARTIAL
        if q_pos.shape[1] % bq:
            want[n_q - 1, :n_q] = PARTIAL               # the ragged last block
        assert torch.equal(classes[0], want) and torch.equal(classes[1], want)
    if kind == "windowed":
        assert FULL in seen and DEAD in seen
