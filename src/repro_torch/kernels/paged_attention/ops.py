"""GQA one-token decode attention read straight from the page pool.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/kernel.py``
(``_decode_kernel``, launched by ``paged_decode_attention``).  The CUDA
kernel is ``csrc/paged_attention.cu``; :func:`paged_decode_attention_plain`
is the same function in plain PyTorch.  :func:`paged_decode_attention`
runs the plain version for CPU tensors only: any other tensor launches
the kernel or raises.

Unlike the reference kernel, which takes compacted ``(Hkv, P, T, D)`` K
and V page arrays, this one reads the pool's own layout: ``pool`` is
``(P_phys, page_elems)`` f32, each page holds ``page_tokens`` token rows
of ``(2, Hkv, D)`` (K at ``t*token_elems + h*D``, V ``Hkv*D`` further on)
followed by slack.  ``page_table`` holds physical pool rows.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "paged_attention"
_SIG = {"paged_attention_decode": (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,                                  # q pool table len out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p)}                   # ... q_bf16, stream
MAX_GROUP = 8                    # query heads per kv head the kernel holds
HEAD_DIMS = (64, 128)
_NEG = -1e30


def _check(q, pool, page_table, lengths, num_kv_heads, page_tokens):
    if q.dim() != 3 or pool.dim() != 2 or page_table.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("expected q (B,H,D), pool (P,E), page_table (B,pps),"
                         " lengths (B,)")
    B, H, D = q.shape
    if H % num_kv_heads:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{num_kv_heads}")
    if page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError("page_table/lengths batch does not match q")
    if page_tokens * 2 * num_kv_heads * D > pool.shape[1]:
        raise ValueError("page_tokens token rows do not fit in a pool page")


def paged_decode_attention_plain(q, pool, page_table, lengths, *,
                                 num_kv_heads: int, page_tokens: int,
                                 window: int = 0,
                                 scale: Optional[float] = None):
    """Plain PyTorch: gather the table's pages, masked softmax in f32.
    Position ``pos`` is valid when ``pos < length`` and, with a window,
    ``pos > length - 1 - window``; an empty row yields zeros."""
    _check(q, pool, page_table, lengths, num_kv_heads, page_tokens)
    B, H, D = q.shape
    Hkv, T = num_kv_heads, page_tokens
    G = H // Hkv
    pps = page_table.shape[1]
    S = pps * T
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pages = pool[page_table.long()][:, :, :T * 2 * Hkv * D].float()
    kv = pages.reshape(B, S, 2, Hkv, D)
    k, v = kv[:, :, 0], kv[:, :, 1]                       # (B,S,Hkv,D)
    s = torch.einsum("bhgd,bshd->bhgs", q.float().reshape(B, Hkv, G, D),
                     k) * scale
    pos = torch.arange(S, device=q.device)[None]
    length = lengths.long()[:, None]
    valid = pos < length
    if window > 0:
        valid &= pos > length - 1 - window
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    out = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, pool, page_table, lengths, *,
                           num_kv_heads: int, page_tokens: int,
                           window: int = 0, scale: Optional[float] = None):
    """q: (B, H, D) f32 or bf16; pool: (P, page_elems) f32; page_table:
    (B, pages_per_seq) int32 physical pool rows (entries past a row's
    length may be any valid row); lengths: (B,) int32.  Returns (B, H, D)
    in q's dtype."""
    if pool.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pool, page_table, lengths, num_kv_heads=num_kv_heads,
            page_tokens=page_tokens, window=window, scale=scale)
    _check(q, pool, page_table, lengths, num_kv_heads, page_tokens)
    B, H, D = q.shape
    G = H // num_kv_heads
    if D not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"kernel serves head_dim in {HEAD_DIMS} and at most"
                         f" {MAX_GROUP} query heads per kv head; got D={D},"
                         f" G={G}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or pool.dtype != torch.float32 \
            or page_table.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("q f32/bf16, pool f32, page_table/lengths int32")
    if pool.shape[1] % 4 or pool.data_ptr() % 16:
        raise ValueError("pool rows must be 16-byte aligned (float4 loads)")
    lib = _build.load(NAME, _SIG)
    for t in (q, pool, page_table, lengths):
        if t.device != pool.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one CUDA device")
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    out = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = lib.paged_attention_decode(
        q.data_ptr(), pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, num_kv_heads, D,
        page_table.shape[1], pool.shape[1], page_tokens, int(window),
        float(scale), int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "paged_attention_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
