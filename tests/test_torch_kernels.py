"""Port kernels: each plain PyTorch version against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the sweeps of
tests/test_kernels.py, and the wrappers' contract (plain only for CPU
tensors, never a silent fallback).  The CUDA kernels themselves are held
to the plain versions on a card by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_copy import ops as jpc
from repro.kernels.paged_attention import ops as jpa, ref as jpa_ref
from repro_torch.kernels import page_copy, paged_attention

RNG = np.random.default_rng(42)


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _t(x) -> torch.Tensor:
    """A reference array as a torch tensor (bf16 through its bits)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _pool_from_pages(kp, vp, slack=128):
    """The port's pool layout holding the same token rows as the
    reference's (Hkv, P, T, D) K/V page arrays: (P, T*2*Hkv*D + slack)
    f32, token rows (2, Hkv, D), slack filled with garbage."""
    k = np.asarray(kp, np.float32).transpose(1, 2, 0, 3)    # (P,T,Hkv,D)
    v = np.asarray(vp, np.float32).transpose(1, 2, 0, 3)
    P = k.shape[0]
    rows = np.stack([k, v], 2).reshape(P, -1)
    junk = RNG.standard_normal((P, slack)).astype(np.float32)
    return torch.from_numpy(np.concatenate([rows, junk], 1))


def _compare(q, kp, vp, pt, lengths, dtype, window=0):
    Hkv, _, T, _ = kp.shape
    got = paged_attention.paged_decode_attention(
        _t(q), _pool_from_pages(kp, vp), _t(pt), _t(lengths),
        num_kv_heads=Hkv, page_tokens=T, window=window)
    assert got.dtype == _t(q).dtype
    kern = jpa.paged_decode_attention(q, kp, vp, pt, lengths, window=window)
    ref = jpa_ref.paged_decode_attention(q, kp, vp, pt, lengths, window=window)
    for exp in (kern, ref):
        np.testing.assert_allclose(_np32(got), np.asarray(exp, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,pps", [
    (2, 8, 2, 16, 4),      # GQA 4:1
    (1, 4, 4, 8, 3),       # MHA
    (3, 16, 2, 32, 2),     # GQA 8:1
    (2, 7, 1, 16, 5),      # odd head count (hymba-like 7:1)
])
def test_paged_attention_plain_matches_reference(B, H, Hkv, T, pps, dtype):
    D, P = 128, 64
    q = jnp.asarray(RNG.standard_normal((B, H, D)), dtype)
    kp = jnp.asarray(RNG.standard_normal((Hkv, P, T, D)), dtype)
    vp = jnp.asarray(RNG.standard_normal((Hkv, P, T, D)), dtype)
    pt = jnp.asarray(RNG.integers(0, P, (B, pps)), jnp.int32)
    lengths = jnp.asarray(RNG.integers(1, pps * T + 1, (B,)), jnp.int32)
    _compare(q, kp, vp, pt, lengths, dtype)


@pytest.mark.parametrize("window", [4, 12, 100])
def test_paged_attention_plain_window(window):
    B, H, Hkv, D, T, pps, P = 2, 8, 2, 128, 8, 4, 32
    q = jnp.asarray(RNG.standard_normal((B, H, D)), jnp.float32)
    kp = jnp.asarray(RNG.standard_normal((Hkv, P, T, D)), jnp.float32)
    vp = jnp.asarray(RNG.standard_normal((Hkv, P, T, D)), jnp.float32)
    pt = jnp.asarray(RNG.integers(0, P, (B, pps)), jnp.int32)
    lengths = jnp.asarray([5, 30], jnp.int32)
    _compare(q, kp, vp, pt, lengths, jnp.float32, window=window)


def test_paged_attention_empty_row_is_zero():
    pool = torch.randn(4, 2 * 64 * 8)
    out = paged_attention.paged_decode_attention(
        torch.randn(2, 2, 64), pool, torch.tensor([[1], [2]], dtype=torch.int32),
        torch.tensor([0, 3], dtype=torch.int32), num_kv_heads=1, page_tokens=8)
    assert torch.equal(out[0], torch.zeros(2, 64))
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# page_copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
@pytest.mark.parametrize("P,R,n", [(16, 1, 4), (64, 4, 64), (8, 2, 8)])
def test_page_gather_plain_matches_reference(P, R, n, dtype):
    pool = jnp.asarray(RNG.integers(-100, 100, (P, R * 128)), dtype)
    idx = jnp.asarray(RNG.integers(0, P, (n,)), jnp.int32)   # may repeat
    got = page_copy.gather_pages(_t(pool), _t(idx).long())
    exp = _t(jpc.gather_pages(pool, idx))
    assert got.dtype == exp.dtype and torch.equal(got, exp)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("P,R,n", [(16, 1, 4), (32, 4, 17)])
def test_page_scatter_plain_matches_reference(P, R, n, dtype):
    pool = jnp.asarray(RNG.standard_normal((P, R * 128)), dtype)
    idx = jnp.asarray(RNG.choice(P, n, replace=False), jnp.int32)
    buf = jnp.asarray(RNG.standard_normal((n, R * 128)), dtype)
    mine = _t(pool)
    page_copy.scatter_pages(mine, _t(idx).long(), _t(buf))
    exp = _t(jpc.scatter_pages(pool, idx, buf))
    assert torch.equal(mine.view(torch.uint8), exp.view(torch.uint8))


def test_page_roundtrip_flat():
    pool = torch.from_numpy(RNG.standard_normal((32, 512)).astype(np.float32))
    expect = pool.clone()
    idx = torch.tensor([3, 9, 27])
    page_copy.scatter_pages(pool, idx, page_copy.gather_pages(pool, idx))
    assert torch.equal(pool, expect)


def test_page_copy_requires_16_byte_rows():
    with pytest.raises(ValueError, match="16 bytes"):
        page_copy.gather_pages(torch.zeros(4, 6), torch.tensor([0]))


# ---------------------------------------------------------------------------
# no silent fallback: a tensor that is not on the CPU goes to the kernel
# ---------------------------------------------------------------------------

def test_wrappers_never_fall_back_for_device_tensors():
    """A tensor that is not on the CPU goes to the kernel: where the CUDA
    library cannot be built (no nvcc) or the device is not a card, each
    wrapper raises instead of running the plain version.  A meta tensor
    stands in for a CUDA tensor on a machine with no card."""
    meta = dict(device="meta")
    no_kernel = (RuntimeError, ValueError)
    with pytest.raises(no_kernel):
        paged_attention.paged_decode_attention(
            torch.empty(1, 2, 64, **meta), torch.empty(4, 256, **meta),
            torch.empty(1, 1, dtype=torch.int32, **meta),
            torch.empty(1, dtype=torch.int32, **meta),
            num_kv_heads=1, page_tokens=2)
    pool = torch.empty(4, 128, **meta)
    idx = torch.empty(2, dtype=torch.int64, **meta)
    with pytest.raises(no_kernel):
        page_copy.gather_pages(pool, idx)
    with pytest.raises(no_kernel):
        page_copy.scatter_pages(pool, idx, torch.empty(2, 128, **meta))
    assert paged_attention.paged_decode_attention.launches == 0
