"""Top-level model API for the dense family: embed, full-sequence forward,
unembed and the paged decode step (reference: ``repro/models/model.py``).

``params`` is the flat ``{path: tensor}`` dictionary of
:mod:`repro_torch.weights`.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm


def embed_inputs(params, cfg, tokens: torch.Tensor):
    """tokens: (B, S) integer.  Returns (x (B,S,d), positions (B,S))."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return params["embed"][tokens], positions


def forward_hidden(params, cfg, tokens, collect_cache: bool = False):
    x, positions = embed_inputs(params, cfg, tokens)
    x, caches = tfm.stack_forward(params, x, cfg, positions,
                                  collect_cache=collect_cache)
    return apply_norm(params, "final_norm", x), caches


def unembed(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> logits (..., Vp) in f32 (tied embeddings read the
    whole table, upcast as the reference does)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ w.float()


def logits_full(params, cfg, tokens):
    x, _ = forward_hidden(params, cfg, tokens)
    return unembed(params, cfg, x)


def decode_step(params, cfg, tokens, pool, page_tables, slots, lengths, *,
                page_tokens: int):
    """One paged decode step.  tokens: (B,) integer, fed at position
    ``lengths - 1``; ``lengths`` (B,) int32 counts the cache's tokens
    including this one.  Writes the step's K/V into ``pool`` at ``slots``
    (see :func:`repro_torch.models.transformer.stack_decode`) and returns
    logits (B, Vp)."""
    x = params["embed"][tokens]
    x = tfm.stack_decode(params, x, cfg, pool, page_tables, slots, lengths,
                         page_tokens=page_tokens)
    return unembed(params, cfg, apply_norm(params, "final_norm", x))
