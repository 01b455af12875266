"""Per-sandbox swap files (§3.4, Fig. 5) over host tensors.

The port's copy of ``repro/core/swap.py``.  Units are CPU tensors, written
as their raw bytes with a dtype tag (``"float32"``, ``"bfloat16"``, ...),
so bf16 weights, which numpy cannot hold, round-trip exactly.  Writes take
zero-copy byte views of the tensors; reads land in fresh buffers that the
returned tensors own.

  * :class:`SwapFile` — the page-fault file: per-unit writes, per-unit or
    vectored reads.
  * :class:`ReapFile` — the REAP file: the working set written with one
    sequential ``pwritev`` and read back with one sequential read.

``_pwritev_full``/``_preadv_full`` retry short transfers, so units and
batches above Linux's ~2 GiB per-call cap (full-width weight leaves) go
through whole.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

#: max io-vectors per preadv/pwritev call (POSIX guarantees >= 16; Linux 1024)
IOV_MAX = 1024


def dtype_tag(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """Zero-copy uint8 view of a CPU tensor's bytes (for pwrite/pwritev)."""
    if t.device.type != "cpu":
        raise ValueError(f"swap units live on the host, got {t.device}")
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def tensor_from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """A tensor over ``buf`` (a fresh writable buffer or uint8 tensor)."""
    dt = getattr(torch, dtype)
    raw = buf if isinstance(buf, torch.Tensor) else \
        torch.frombuffer(buf, dtype=torch.uint8) if len(buf) else \
        torch.empty(0, dtype=torch.uint8)
    if raw.storage_offset() % dt.itemsize:
        raw = raw.clone()                   # a dtype view needs alignment
    return raw.view(dt).reshape(shape)


def _full_io(op, fd, bufs, offset: int, what: str) -> None:
    """Issue ``op(fd, bufs, offset)`` until every buffer is transferred."""
    views = [memoryview(b).cast("B") for b in bufs]
    want = sum(len(v) for v in views)
    done = 0
    while done < want:
        pending, skip = [], done
        for v in views:
            if skip >= len(v):
                skip -= len(v)
                continue
            pending.append(v[skip:] if skip else v)
            skip = 0
        n = op(fd, pending[:IOV_MAX], offset + done)
        if n <= 0:                         # pragma: no cover - EOF/IO error
            raise EOFError(f"{what}: short transfer at offset {offset + done}")
        done += n


def _preadv_full(fd, bufs, offset: int) -> None:
    _full_io(os.preadv, fd, bufs, offset, "preadv")


def _pwritev_full(fd, bufs, offset: int) -> None:
    _full_io(os.pwritev, fd, bufs, offset, "pwritev")


@dataclass
class _Extent:
    offset: int
    nbytes: int
    dtype: str
    shape: Tuple[int, ...]


def read_extents(fd, extents: Sequence[Tuple[int, int]]) -> List[bytearray]:
    """Vectored read of ``(offset, nbytes)`` extents pre-sorted by offset:
    adjacent extents merge into runs and each run is one ``preadv``.
    Returns the filled buffers in input order."""
    bufs: List[bytearray] = []
    run: List[bytearray] = []
    run_start = run_end = None

    def flush():
        if run:
            _preadv_full(fd, run, run_start)
            run.clear()

    for off, n in extents:
        if run_end is not None and off != run_end:
            flush()
            run_start = None
        if run_start is None:
            run_start = off
        buf = bytearray(n)
        run.append(buf)
        bufs.append(buf)
        run_end = off + n
    flush()
    return bufs


class _FileBase:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        self.extents: Dict[Hashable, _Extent] = {}
        self._append_at = 0

    def delete(self) -> None:
        """Sandbox termination: close and unlink (§3.4)."""
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None
        for p in (self.path, self.path + ".tmp"):
            if os.path.exists(p):
                os.unlink(p)
        self.extents.clear()

    def __contains__(self, key) -> bool:
        return key in self.extents

    def read_units(self, keys: Sequence[Hashable]
                   ) -> Dict[Hashable, torch.Tensor]:
        """Vectored batch read of a fault set: extents sorted by offset,
        adjacent ones merged into one ``preadv`` run each."""
        exts = sorted(((k, self.extents[k]) for k in keys),
                      key=lambda kv: kv[1].offset)
        bufs = read_extents(self.fd, [(e.offset, e.nbytes) for _, e in exts])
        return {key: tensor_from_bytes(buf, ext.dtype, ext.shape)
                for (key, ext), buf in zip(exts, bufs)}


class SwapFile(_FileBase):
    """Page-fault swap file: per-unit writes, random per-unit reads."""

    def write_unit(self, key: Hashable, arr: torch.Tensor) -> None:
        buf = tensor_bytes(arr)
        ext = self.extents.get(key)
        if ext is None or ext.nbytes < buf.nbytes:
            ext = _Extent(self._append_at, buf.nbytes, dtype_tag(arr),
                          tuple(arr.shape))
            self._append_at += buf.nbytes
        else:
            ext = _Extent(ext.offset, buf.nbytes, dtype_tag(arr),
                          tuple(arr.shape))
        _pwritev_full(self.fd, [buf], ext.offset)
        self.extents[key] = ext

    def write_units(self, items: Sequence[Tuple[Hashable, torch.Tensor]]
                    ) -> int:
        """Write each unit; returns the bytes written."""
        n = 0
        for k, a in items:
            self.write_unit(k, a)
            n += a.nbytes
        return n


class ReapFile(_FileBase):
    """REAP file: one batch-sequential write, one batch-sequential read."""

    def write_batch(self, items: Sequence[Tuple[Hashable, torch.Tensor]]
                    ) -> None:
        """One vectored sequential write of the units, committed
        torn-write-safely: written to ``<path>.tmp`` and renamed over the
        live file once fully on disk; extents are installed after."""
        bufs: List[np.ndarray] = []
        new_extents: Dict[Hashable, _Extent] = {}
        off = 0
        for key, arr in items:
            b = tensor_bytes(arr)
            new_extents[key] = _Extent(off, b.nbytes, dtype_tag(arr),
                                       tuple(arr.shape))
            bufs.append(b)
            off += b.nbytes
        tmp = self.path + ".tmp"
        tmp_fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            if bufs:
                _pwritev_full(tmp_fd, bufs, 0)
            os.rename(tmp, self.path)      # the commit point
        except BaseException:
            os.close(tmp_fd)
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        os.close(self.fd)
        self.fd = tmp_fd
        self.extents = new_extents
        self._append_at = off

    def read_batch(self) -> Dict[Hashable, torch.Tensor]:
        """One sequential read of the whole file into one host buffer; the
        units are views of it."""
        blob = torch.empty(self._append_at, dtype=torch.uint8)
        if self._append_at:
            _preadv_full(self.fd, [blob.numpy()], 0)
        return {key: tensor_from_bytes(
                    blob[ext.offset:ext.offset + ext.nbytes], ext.dtype,
                    ext.shape)
                for key, ext in self.extents.items()}
