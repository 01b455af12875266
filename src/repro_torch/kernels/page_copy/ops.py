"""Batched page gather and in-place scatter over the page pool.

Replaces the Pallas TPU kernels ``repro/kernels/page_copy/kernel.py``
(``_copy_kernel`` launched by ``gather_pages``, ``_scatter_kernel``
launched by ``scatter_pages``):

  gather : out[i]       = pool[idx[i]]   (deflate: pages -> one buffer)
  scatter: pool[idx[i]] = buf[i]         (wake and fault: in place)

The CUDA kernels are ``csrc/page_copy.cu``; ``*_plain`` are the same
functions in plain PyTorch, which the wrappers run for CPU tensors only.
Pages are copied as raw bytes, so f32, bf16 and int32 pools share one
kernel; a page row must be a multiple of 16 bytes (the TPU wrapper's
``as_pages`` sets the same alignment contract).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "page_copy"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p)
_SIG = {"page_gather": _ARGS, "page_scatter": _ARGS}
DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _check(pool, idx, buf=None):
    if pool.dim() != 2 or pool.dtype not in DTYPES:
        raise TypeError(f"pool must be 2-D {DTYPES}, got {pool.dtype} "
                        f"{tuple(pool.shape)}")
    if pool.shape[1] * pool.element_size() % 16:
        raise ValueError(f"page of {pool.shape[1]} {pool.dtype} elements is "
                         "not a multiple of 16 bytes")
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise TypeError("idx must be a 1-D int64 tensor")
    if buf is not None and (buf.dtype != pool.dtype or buf.dim() != 2
                            or buf.shape != (idx.shape[0], pool.shape[1])):
        raise ValueError(f"buf must be ({idx.shape[0]}, {pool.shape[1]}) "
                         f"{pool.dtype}")


def gather_pages_plain(pool, idx):
    _check(pool, idx)
    return pool[idx]


def scatter_pages_plain(pool, idx, buf):
    _check(pool, idx, buf)
    pool[idx] = buf
    return pool


def _launch(fn: str, pool, idx, src, dst):
    lib = _build.load(NAME, _SIG)
    for t in (pool, idx, src, dst):
        if t.device != pool.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous on one CUDA device")
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("page buffers must be 16-byte aligned")
    if pool.device.type != "cuda":
        raise ValueError(f"unsupported device {pool.device}")
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = getattr(lib, fn)(src.data_ptr(), idx.data_ptr(), dst.data_ptr(),
                           idx.shape[0], pool.shape[1] * pool.element_size(),
                           pool.shape[0], stream)
    _build.check(lib, err, fn)


def gather_pages(pool, idx):
    """pool: (P, E); idx: (n,) int64 (may repeat) -> (n, E)."""
    if pool.device.type == "cpu":
        return gather_pages_plain(pool, idx)
    _check(pool, idx)
    out = torch.empty((idx.shape[0], pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    if idx.shape[0]:
        _launch("page_gather", pool, idx, pool, out)
        gather_pages.launches += 1
    return out


def scatter_pages(pool, idx, buf):
    """pool[idx[i]] = buf[i] in place (idx distinct); no other page
    changes.  Returns ``pool``."""
    if pool.device.type == "cpu":
        return scatter_pages_plain(pool, idx, buf)
    _check(pool, idx, buf)
    if idx.shape[0]:
        _launch("page_scatter", pool, idx, buf, pool)
        scatter_pages.launches += 1
    return pool


gather_pages.launches = 0
scatter_pages.launches = 0
