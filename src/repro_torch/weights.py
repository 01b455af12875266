"""Flat parameter dictionaries keyed by the reference's pytree path strings.

A model's parameters are one ``dict[str, Tensor]`` keyed exactly like the
reference's flattened pytree (``core/instance.py`` ``_path_str``):
``embed``, ``final_norm/scale``, ``layers/attn/wq`` ... .  Per-layer leaves
keep the reference's stacked layout with a leading ``num_layers`` axis, so
the swappable weight units (and their byte counts) are the reference's.
Keys are kept in the reference's flatten order (sorted paths), which is
the order the unit catalog, and hence the REAP recorder, walks.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                      # a writable copy we own
    if arr.dtype.name == "bfloat16":         # ml_dtypes bf16: no numpy twin
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(flat: Mapping[str, np.ndarray], device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Carry a reference parameter set across: ``flat`` maps path strings
    to host arrays (the reference's ``ModelInstance.weights``)."""
    dev = resolve_device(device)
    return {path: _to_tensor(a).to(dev) for path, a in flat.items()}


def init_params(cfg, generator: torch.Generator, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the reference's shapes, scales and
    dtypes (``models/layers.py`` ``dense_init``/``embed_init``): for use on
    the card without a checkpoint.  The numbers differ from the
    reference's (another generator); the shapes and layout do not."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings are not ported yet")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, Hkv, D, Vp = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.padded_vocab

    def normal(shape, scale):
        # one layer at a time keeps the f32 temporary small at full width
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=generator, device=dev,
                                 dtype=torch.float32).mul_(scale)
        return out

    def dense(shape):                           # (L, fan_in, fan_out)
        return normal(shape, 1.0 / math.sqrt(shape[1]))

    p = {"embed": normal((Vp, d), 0.02),
         "final_norm/scale": torch.ones(d, dtype=torch.float32, device=dev),
         "layers/attn/wq": dense((L, d, H * D)),
         "layers/attn/wk": dense((L, d, Hkv * D)),
         "layers/attn/wv": dense((L, d, Hkv * D)),
         "layers/attn/wo": dense((L, H * D, d)),
         "layers/ln1/scale": torch.ones(L, d, dtype=torch.float32, device=dev),
         "layers/ln2/scale": torch.ones(L, d, dtype=torch.float32, device=dev)}
    if cfg.activation == "swiglu":
        p["layers/mlp/w_gate"] = dense((L, d, f))
    p["layers/mlp/w_up"] = dense((L, d, f))
    p["layers/mlp/w_down"] = dense((L, f, d))
    return {k: p[k] for k in sorted(p)}
