"""Port model (dense GQA, tiny llama3.2-3b) against repro.models on the same
weights: layers, prefill logits, and a multi-step paged decode against the
reference's dense decode_step.  f32 throughout; tolerances 1e-4 (the two
frameworks sum in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, tiny_config as jtiny
from repro.core.instance import _path_str
from repro.models import layers as jlayers, model as jmodel
from repro_torch.configs import get_config, tiny_config
from repro_torch.core.pool import PagePool
from repro_torch.models import layers, model
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.weights import init_params, params_from_jax

ARCH = "llama3.2-3b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _flat(params):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(scope="module")
def both(tiny_factory):
    jcfg, jparams = tiny_factory(ARCH)
    cfg = tiny_config(get_config(ARCH))
    return jcfg, jparams, cfg, params_from_jax(_flat(jparams), device="cpu")


def test_configs_match_reference():
    for mk in (lambda c: c, jtiny):
        ref = mk(jget_config(ARCH))
        mine = mk(get_config(ARCH)) if mk is not jtiny \
            else tiny_config(get_config(ARCH))
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.padded_vocab == ref.padded_vocab


def test_init_params_has_reference_layout(both):
    _, jparams, cfg, params = both
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _flat(jparams)
    assert list(mine) == list(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == v.shape
        assert str(mine[k].dtype) == f"torch.{v.dtype}"


@pytest.mark.parametrize("mode", ["full", "2d"])
def test_rope_and_norms_match_reference(mode):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            500_000.0, mode)
    exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    s, b = rng.standard_normal(64).astype(np.float32), \
        rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s))), **TOL)
    np.testing.assert_allclose(
        layers.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(b)).numpy(),
        np.asarray(jlayers.layernorm(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_oracle_and_paged_agree(window):
    """The port's dense decode oracle equals the reference's, and the paged
    path (the kernel's plain version) equals it on the same logical cache
    (twin of test_paged_attention_matches_dense_decode)."""
    from repro.models.attention import decode_attention as jdecode
    from repro_torch.kernels import paged_attention
    from repro_torch.models.attention import decode_attention
    rng = np.random.default_rng(4)
    B, H, Hkv, D, T, pps, P = 2, 8, 4, 64, 16, 4, 32
    S = T * pps
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    lengths = np.asarray([S - 3, 20], np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, pos, lengths)),
                           window=window)
    exp = jdecode(*map(jnp.asarray, (q, k, v, pos, lengths)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    # the same cache laid out in pool pages, rows scattered by a page table
    table = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    pool = torch.zeros(P, T * 2 * Hkv * D)
    rows = np.stack([k, v], 2).reshape(B, pps, T * 2 * Hkv * D)
    pool[torch.from_numpy(table).long()] = torch.from_numpy(rows)
    paged = paged_attention.paged_decode_attention(
        torch.from_numpy(q), pool, torch.from_numpy(table),
        torch.from_numpy(lengths), num_kv_heads=Hkv, page_tokens=T,
        window=window or 0)
    torch.testing.assert_close(paged, got, **TOL)


def test_prefill_logits_match_reference(both):
    jcfg, jparams, cfg, params = both
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    exp, _ = jmodel.logits_full(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    got = model.logits_full(params, cfg, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == exp.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def _paged_prefill(cfg, params, tokens, page_elems=16384):
    """Prefill every row into its own session of a fresh paged cache."""
    pool = PagePool(page_elems, capacity_pages=1024, device="cpu")
    kv = PagedKVCache("t", cfg, pool)
    _, caches = model.forward_hidden(params, cfg, torch.from_numpy(tokens),
                                     collect_cache=True)
    sids = [f"s{b}" for b in range(tokens.shape[0])]
    for b, sid in enumerate(sids):
        kv.new_session(sid)
        for layer in range(cfg.num_layers):
            kv.write_tokens(sid, layer, torch.stack(
                [caches["k"][layer, b], caches["v"][layer, b]], 1), 0)
        kv.sessions[sid].num_tokens = tokens.shape[1]
    return kv, sids


def _paged_step(cfg, params, kv, sids, fed):
    L = cfg.num_layers
    start = [kv.sessions[s].num_tokens for s in sids]
    for b, sid in enumerate(sids):
        for layer in range(L):
            kv.reserve_tokens(sid, layer, start[b], 1)
    tables = torch.from_numpy(np.stack([kv.page_table(sids, layer)
                                        for layer in range(L)]))
    slots = torch.from_numpy(np.stack(
        [np.concatenate([kv.token_offsets(s, layer, start[b], 1)
                         for b, s in enumerate(sids)]) for layer in range(L)]))
    lengths = torch.tensor(start, dtype=torch.int32) + 1
    logits = model.decode_step(params, cfg, torch.from_numpy(fed),
                               kv.pool.data, tables, slots, lengths,
                               page_tokens=kv.page_tokens)
    for sid in sids:
        kv.sessions[sid].num_tokens += 1
    return logits


@pytest.mark.parametrize("page_elems", [16384, 512])
def test_paged_decode_matches_reference_decode_step(both, page_elems):
    """Several paged decode steps (K/V written into pool pages, attention
    through the paged kernel's path) against the reference's dense
    ``decode_step``; page_elems=512 puts 2 tokens on a page, so the
    steps cross page boundaries."""
    jcfg, jparams, cfg, params = both
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 7))
    _, cache = jmodel.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                              max_len=16)
    kv, sids = _paged_prefill(cfg, params, tokens, page_elems)
    for _ in range(4):
        fed = rng.integers(0, cfg.vocab_size, (2,))
        exp, cache = jmodel.decode_step(jparams, jcfg,
                                        jnp.asarray(fed, jnp.int32), cache)
        got = _paged_step(cfg, params, kv, sids, fed)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_decode_matches_full_forward(both):
    """Twin of test_models.py's decode consistency: prefill S tokens, one
    paged decode step of token S, equals the full forward's row S."""
    _, _, cfg, params = both
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 9))
    full = model.logits_full(params, cfg, torch.from_numpy(tokens))[:, -1]
    kv, sids = _paged_prefill(cfg, params, tokens[:, :-1])
    got = _paged_step(cfg, params, kv, sids, tokens[:, -1])
    torch.testing.assert_close(got, full, **TOL)
