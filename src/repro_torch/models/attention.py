"""GQA attention: prefill (plain PyTorch), dense decode (kept as the
reference oracle for tests) and paged decode through the hand-written
``paged_attention`` kernel (reference: ``repro/models/attention.py``).

Layouts follow the reference: activations (B, S, H, D), K/V (B, S, Hkv, D),
query heads grouped as (Hkv, G) with G = H // Hkv.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import paged_attention
from repro_torch.models.layers import apply_rope

_NEG = -1e30


def flash_attention(q, k, v) -> torch.Tensor:
    """Causal prefill attention.  q: (B,S,H,D); k,v: (B,S,Hkv,D).  Returns
    (B,S,H,D) in q.dtype.

    Scores in f32, masked softmax in one pass.  The reference scans the
    keys in blocks of 1024 with an online softmax; for Sk <= 1024 that is
    this single pass exactly, and longer prompts differ only in rounding.
    The probabilities are rounded to v's dtype before the PV product, as
    the reference does.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = o / l.clamp_min(1e-30)                           # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q, k, v, kv_positions, lengths, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Dense single-token decode (the oracle the paged kernel is held to).

    q: (B, H, D); k,v: (B, S, Hkv, D); kv_positions: (B, S) global position
    of each slot (-1 empty); lengths: (B,).
    """
    B, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s = torch.einsum("bhgd,bshd->bhgs", q.float().reshape(B, Hkv, G, D),
                     k.float()) * (1.0 / math.sqrt(D))
    valid = (kv_positions >= 0) & (kv_positions < lengths[:, None])
    if window is not None:
        valid &= kv_positions > lengths[:, None] - 1 - window
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * valid[:, None, None, :]
    l = p.sum(-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def gqa_project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["attn/wq"]).reshape(B, S, H, D)
    k = (x @ p["attn/wk"]).reshape(B, S, Hkv, D)
    v = (x @ p["attn/wv"]).reshape(B, S, Hkv, D)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_mode)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_mode)
    return q, k, v


def gqa_forward(p, x, cfg, positions):
    """Full-sequence causal attention.  Returns (out (B,S,d), (k, v))."""
    B, S, _ = x.shape
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v)
    return out.reshape(B, S, -1) @ p["attn/wo"], (k, v)


def _rope_at(t, cfg, lengths):
    """Rotate one token per row, t: (B, heads, D), at position lengths-1."""
    if cfg.rope_mode == "none":
        return t
    pos = (lengths.long() - 1)[:, None]
    return apply_rope(t[:, None], pos, cfg.rope_theta, cfg.rope_mode)[:, 0]


def gqa_new_kv(p, x, cfg, lengths):
    """This step's token as (k, v) cache entries.  x: (B, d)."""
    B = x.shape[0]
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    k = (x @ p["attn/wk"]).reshape(B, Hkv, D)
    v = (x @ p["attn/wv"]).reshape(B, Hkv, D)
    return _rope_at(k, cfg, lengths), v


def gqa_decode(p, x, cfg, pool, page_table, lengths, *, page_tokens: int
               ) -> torch.Tensor:
    """Paged decode.  x: (B, d); pool: the (P, page_elems) f32 page pool;
    page_table: (B, pages_per_seq) int32 physical pool rows; lengths: (B,)
    int32 tokens in the cache including this step's.  Returns (B, d)."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q = _rope_at((x @ p["attn/wq"]).reshape(B, H, D), cfg, lengths)
    out = paged_attention.paged_decode_attention(
        q, pool, page_table, lengths, num_kv_heads=cfg.num_kv_heads,
        page_tokens=page_tokens)
    return out.reshape(B, H * D) @ p["attn/wo"]
