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
