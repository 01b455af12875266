"""On the card: each CUDA kernel of the port against its plain PyTorch
version.  Imports neither JAX nor the reference, so it runs where the port
runs: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Every test skips without a GPU (the kernels have no CPU mode)."""
import pytest
import torch

from repro_torch.kernels import page_copy, paged_attention


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,window", [(24, 8, 128, 0), (7, 1, 128, 9),
                                            (4, 2, 64, 0)])
def test_paged_attention_kernel_matches_plain(cuda, H, Hkv, D, window, qdtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    pool = torch.randn(64, 16384, generator=g, device=cuda)
    T = 16384 // (2 * Hkv * D)
    lengths = torch.tensor([1, T + 3, 5 * T], dtype=torch.int32, device=cuda)
    table = torch.randperm(64, generator=g, device=cuda)[:15].reshape(3, 5) \
        .to(torch.int32)
    q = torch.randn(3, H, D, generator=g, device=cuda).to(qdtype)
    kw = dict(num_kv_heads=Hkv, page_tokens=T, window=window)
    got = paged_attention.paged_decode_attention(q, pool, table, lengths, **kw)
    exp = paged_attention.paged_decode_attention_plain(q, pool, table,
                                                       lengths, **kw)
    tol = 2e-2 if qdtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_page_copy_kernels_match_plain(cuda, dtype):
    pool = torch.arange(64 * 1024, device=cuda).reshape(64, 1024).to(dtype)
    idx = torch.tensor([5, 0, 63, 5], device=cuda)
    assert torch.equal(page_copy.gather_pages(pool, idx),
                       page_copy.gather_pages_plain(pool, idx))
    buf = torch.full((3, 1024), 7, device=cuda).to(dtype)
    exp = page_copy.scatter_pages_plain(pool.clone(), idx[1:], buf)
    # idx[1:] is only 8-byte aligned: enough for the int64 indices
    assert torch.equal(page_copy.scatter_pages(pool, idx[1:], buf), exp)
    with pytest.raises(ValueError, match="16-byte"):     # 4 or 8 bytes off
        page_copy.gather_pages(pool.view(-1)[2:1026].view(1, 1024),
                               torch.zeros(1, dtype=torch.long, device=cuda))
