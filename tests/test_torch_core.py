"""Port core against the reference: allocator, state graph, page pool,
paged KV cache (same page ids, accounting and page contents after the same
writes), and the swap files' byte-exact round trip, bf16 included."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, tiny_config as jtiny
from repro.core import bitmap_alloc as jalloc, state as jstate
from repro.core.pool import PagePool as JPool
from repro.core.swap import ReapFile as JReap, SwapFile as JSwap
from repro.serving.paged_kv import PagedKVCache as JKV
from repro_torch.configs import get_config, tiny_config
from repro_torch.core import bitmap_alloc, state
from repro_torch.core.pool import PagePool
from repro_torch.core.swap import ReapFile, SwapFile
from repro_torch.serving.paged_kv import PagedKVCache

PB = bitmap_alloc.PAGES_PER_BLOCK


# ---------------------------------------------------------------------------
# allocator and state graph: framework-free copies must behave identically
# ---------------------------------------------------------------------------

def test_allocator_twin_of_reference():
    rng = np.random.default_rng(0)
    a, b = bitmap_alloc.BitmapPageAllocator(), jalloc.BitmapPageAllocator()
    live = []
    for _ in range(3000):
        if live and rng.random() < 0.45:
            p = live.pop(int(rng.integers(len(live))))
            assert a.free(p) == b.free(p)
        else:
            p = a.alloc()
            assert p == b.alloc() and p % PB != 0      # control page reserved
            live.append(p)
        assert a.allocated_pages == b.allocated_pages
        assert a.committed_blocks == b.committed_blocks
    a.check_invariants()
    assert a.stats == b.stats


def test_allocator_refcount_and_limit():
    a = bitmap_alloc.BitmapPageAllocator(max_blocks=1)
    p = a.alloc()
    a.incref(p)
    assert a.decref(p) is False and a.decref(p) is True
    with pytest.raises(ValueError):
        a.refcount(p)
    a.alloc_many(bitmap_alloc.USABLE_PER_BLOCK)
    with pytest.raises(MemoryError):
        a.alloc()


def test_state_graph_is_the_reference():
    def names(table):
        return {(s.value, e.value): (n.value, tag)
                for (s, e), (n, tag) in table.items()}
    assert names(state.TRANSITIONS) == names(jstate.TRANSITIONS)
    sm = state.StateMachine()
    for ev in ("cold_start", "request", "finish", "sigstop", "request",
               "finish"):
        sm.fire(state.Event(ev))
    assert sm.state == state.ContainerState.WOKEN
    with pytest.raises(state.InvalidTransition):
        sm.fire(state.Event.FINISH)


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------

def test_pool_scatter_gather_roundtrip():
    pool = PagePool(page_elems=64, capacity_pages=4 * PB, device="cpu")
    pages = pool.alloc(3, "t0")
    data = torch.arange(3 * 64, dtype=torch.float32).reshape(3, 64)
    pool.scatter(pages, data)
    assert torch.equal(pool.gather(pages), data)
    assert pool.scatter_calls == 1


def test_pool_cow_pss_and_break():
    pool = PagePool(page_elems=64, device="cpu", capacity_pages=PB)
    pages = pool.alloc(4, "a")
    pool.scatter(pages, torch.ones(4, 64))
    pool.share(pages[:2], "b")
    pb = pool.page_bytes
    assert pool.rss_bytes("b") == 2 * pb
    assert pool.pss_bytes("a") == pytest.approx(2 * pb + 2 * pb / 2)
    new = pool.break_cow(pages[0], "b")
    assert new not in pages and pool.refcount(pages[0]) == 1
    assert torch.equal(pool.gather([new]), torch.ones(1, 64))
    assert pool.free(pages[:2], "a") == 1             # pages[1] still b's


def test_pool_block_release_and_capacity():
    pool = PagePool(page_elems=8, capacity_pages=2 * PB, device="cpu")
    pool.alloc(PB + 5, "t")
    assert pool.committed_bytes == 2 * PB * pool.page_bytes
    pool.free_owner("t")
    assert pool.committed_bytes == 0
    pool.alloc(2 * (PB - 1), "t")
    with pytest.raises(MemoryError):
        pool.alloc(1, "t")


# ---------------------------------------------------------------------------
# paged KV: same writes -> same pages, accounting and contents
# ---------------------------------------------------------------------------

def _pair(page_elems):
    jcfg = jtiny(jget_config("llama3.2-3b"))
    cfg = tiny_config(get_config("llama3.2-3b"))
    jkv = JKV("i0", jcfg, JPool(page_elems, capacity_pages=PB))
    kv = PagedKVCache("i0", cfg, PagePool(page_elems, capacity_pages=PB,
                                          device="cpu"))
    return jkv, kv


def _same_state(jkv, kv):
    assert {s: v.pages for s, v in jkv.sessions.items()} == \
        {s: v.pages for s, v in kv.sessions.items()}
    assert kv.pool.used_bytes == jkv.pool.used_bytes
    assert kv.pool.committed_bytes == jkv.pool.committed_bytes
    pids = [p for s in kv.sessions.values() for layer in s.pages
            for p in layer if p is not None]
    if pids:
        np.testing.assert_allclose(
            kv.pool.gather(pids).numpy(),
            jkv.pool.data[jkv.pool._phys(pids)], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("page_elems", [16384, 256, 512])
def test_paged_kv_twin_writes_pages_and_accounting(page_elems):
    jkv, kv = _pair(page_elems)
    rng = np.random.default_rng(0)
    for sid, n0, n in (("a", 0, 37), ("b", 0, 5), ("a", 37, 9), ("b", 5, 70)):
        for kvc in (jkv, kv):
            if sid not in kvc.sessions:
                kvc.new_session(sid)
        data = rng.standard_normal((n, kv.token_elems)).astype(np.float32)
        for layer in range(kv.cfg.num_layers):
            assert kv.write_tokens(sid, layer, torch.from_numpy(data), n0) == \
                jkv.write_tokens(sid, layer, data, n0)
        for kvc in (jkv, kv):
            kvc.sessions[sid].num_tokens = n0 + n
    _same_state(jkv, kv)
    np.testing.assert_allclose(kv.read_tokens("b", 1, 75).numpy(),
                               jkv.read_tokens("b", 1, 75), rtol=0, atol=0)
    assert kv.keys_for("a") == jkv.keys_for("a")
    assert kv.keys_for("a", window_tokens=10) == jkv.keys_for("a", 10)
    for kvc in (jkv, kv):
        kvc.close_session("b")
    assert kv.trim() == jkv.trim()
    _same_state(jkv, kv)


def test_paged_kv_swap_cycle_twin(spool_dir):
    """export (zero tails) -> REAP/swap files -> drop -> REAP prefetch ->
    fault: the port restores the same bytes and page ids as the
    reference, and its exported pages equal the reference's exports."""
    jkv, kv = _pair(512)
    data = np.random.default_rng(1).standard_normal(
        (11, kv.token_elems)).astype(np.float32)
    for kvc, arr in ((jkv, data), (kv, torch.from_numpy(data))):
        kvc.new_session("s")
        for layer in range(kv.cfg.num_layers):
            kvc.write_tokens("s", layer, arr, 0)
        kvc.sessions["s"].num_tokens = 11
    ws = frozenset([("kv", "s", 0, 0), ("kv", "s", 1, 5)])
    (jr, js), (r, s) = jkv.export_items(ws), kv.export_items(ws)
    assert [k for k, _ in r] == [k for k, _ in jr]
    assert [k for k, _ in s] == [k for k, _ in js]
    for (_, a), (_, b) in zip(r + s, jr + js):
        np.testing.assert_array_equal(a.numpy(), b)    # zero tail included
    reap, swap = ReapFile(f"{spool_dir}/t.reap"), SwapFile(f"{spool_dir}/t.swap")
    jreap, jswap = JReap(f"{spool_dir}/j.reap"), JSwap(f"{spool_dir}/j.swap")
    reap.write_batch(r)
    swap.write_units(s)
    jreap.write_batch(jr)
    jswap.write_units(js)
    assert kv.drop_pages() == jkv.drop_pages()
    assert kv.pool.used_bytes == 0
    assert kv.apply_prefetch(reap.read_batch()) == \
        jkv.apply_prefetch(jreap.read_batch())
    missing = kv.nonresident_keys(kv.keys_for("s"))
    assert missing == jkv.nonresident_keys(jkv.keys_for("s"))
    assert kv.fault_in(missing, swap, reap) == \
        jkv.fault_in(missing, jswap, jreap)
    _same_state(jkv, kv)
    torch.testing.assert_close(kv.read_tokens("s", 1, 11),
                               torch.from_numpy(data), rtol=0, atol=0)
    for f in (reap, swap, jreap, jswap):
        f.delete()


# ---------------------------------------------------------------------------
# swap files: raw bytes with a dtype tag (bf16 has no numpy dtype)
# ---------------------------------------------------------------------------

def test_swap_files_roundtrip_bf16_exactly(spool_dir):
    g = torch.Generator().manual_seed(0)
    units = [(("w", "odd", -1), torch.randn(3, 5, generator=g).bfloat16()),
             (("w", "f32", -1), torch.randn(7, 4, generator=g)),
             (("w", "bf16", 2), torch.randn(4, 64, generator=g).bfloat16()),
             (("w", "i32", -1), torch.arange(9, dtype=torch.int32)),
             (("w", "empty", -1), torch.zeros(0, 4).bfloat16())]
    reap = ReapFile(f"{spool_dir}/u.reap")
    swap = SwapFile(f"{spool_dir}/u.swap")
    reap.write_batch(units)          # the f32 unit lands 30 bytes in
    assert swap.write_units(units) == sum(t.nbytes for _, t in units)
    for got in (reap.read_batch(), reap.read_units([k for k, _ in units]),
                swap.read_units([k for k, _ in units])):
        for k, t in units:
            assert got[k].dtype == t.dtype and got[k].shape == t.shape
            assert torch.equal(got[k].view(torch.uint8) if t.numel() else
                               got[k], t.view(torch.uint8) if t.numel() else t)
    assert torch.equal(swap.read_units([("w", "bf16", 2)])[("w", "bf16", 2)],
                       units[2][1])
    reap.delete()
    swap.delete()
