"""Dense transformer block and layer stack (reference:
``repro/models/transformer.py``, dense GQA family).

Parameters stay in the reference's stacked layout (leading ``num_layers``
axis); :func:`layer_params` slices one layer's view.  Decode is paged: the
step's new K/V rows are written into the page pool in place, then the
``paged_attention`` kernel reads the pool through the page table.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm

_LAYER = "layers/"


def layer_params(params: Dict[str, torch.Tensor], layer: int
                 ) -> Dict[str, torch.Tensor]:
    """One layer's parameters, keyed without the ``layers/`` prefix."""
    return {k[len(_LAYER):]: v[layer] for k, v in params.items()
            if k.startswith(_LAYER)}


def block_forward(p, x, cfg, positions):
    """x: (B,S,d).  Returns (x', (k, v))."""
    h = apply_norm(p, "ln1", x)
    a_out, kv = attn.gqa_forward(p, h, cfg, positions)
    x = x + a_out
    h = apply_norm(p, "ln2", x)
    return x + apply_mlp(p, h), kv


def block_decode(p, x, cfg, pool, page_table, slots, lengths, *,
                 page_tokens: int):
    """One decode step of one layer.  x: (B, d).

    ``slots`` (B,) int64 are the flat pool offsets of each row's new token
    (the row layout is ``(2, Hkv, D)``: K then V).  K/V are computed in
    the model dtype and stored as f32, so the pool holds the same values
    the reference's f32 pool does.
    """
    h = apply_norm(p, "ln1", x)
    k_new, v_new = attn.gqa_new_kv(p, h, cfg, lengths)
    B = x.shape[0]
    row = torch.cat([k_new.reshape(B, -1), v_new.reshape(B, -1)], 1)
    cols = torch.arange(row.shape[1], device=pool.device)
    pool.view(-1)[slots[:, None] + cols] = row.to(pool.dtype)
    x = x + attn.gqa_decode(p, h, cfg, pool, page_table, lengths,
                            page_tokens=page_tokens)
    h = apply_norm(p, "ln2", x)
    return x + apply_mlp(p, h)


def stack_forward(params, x, cfg, positions, *, collect_cache: bool = False):
    """Run every layer.  Returns (x, caches) with caches
    ``{"k": (L,B,S,Hkv,D), "v": ...}`` when ``collect_cache``."""
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        x, (k, v) = block_forward(layer_params(params, layer), x, cfg,
                                  positions)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_cache else None
    return x, caches


def stack_decode(params, x, cfg, pool, page_tables, slots, lengths, *,
                 page_tokens: int):
    """page_tables: (L, B, pages_per_seq) int32; slots: (L, B) int64."""
    for layer in range(cfg.num_layers):
        x = block_decode(layer_params(params, layer), x, cfg, pool,
                         page_tables[layer], slots[layer], lengths,
                         page_tokens=page_tokens)
    return x
