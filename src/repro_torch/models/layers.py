"""Shared layers: norms, rotary embeddings, the MLP (reference:
``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def apply_norm(p, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """``p[prefix + "/scale"]`` (and ``/bias`` for a layernorm)."""
    bias = p.get(prefix + "/bias")
    if bias is not None:
        return layernorm(x, p[prefix + "/scale"], bias)
    return rmsnorm(x, p[prefix + "/scale"])


def rope_freqs(head_dim: int, theta: float, rotary_dim=None,
               device=None) -> torch.Tensor:
    rotary_dim = rotary_dim or head_dim
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return 1.0 / (theta ** exponent)                       # (rotary_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "full") -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.

    mode "full" rotates all D dims as interleaved (even, odd) pairs; "2d"
    (ChatGLM partial rotary) rotates the first half and passes the rest.
    """
    if mode == "none":
        return x
    D = x.shape[-1]
    rot = D if mode == "full" else D // 2
    inv = rope_freqs(D, theta, rot, device=x.device)
    ang = positions[..., None].float() * inv               # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).reshape(xr.shape)
    if rot < D:
        out = torch.cat([out, x[..., rot:].float()], -1)
    return out.to(x.dtype)


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """p holds ``mlp/w_up``, ``mlp/w_down`` and, for SwiGLU, ``mlp/w_gate``."""
    w_gate = p.get("mlp/w_gate")
    if w_gate is not None:
        h = F.silu(x @ w_gate) * (x @ p["mlp/w_up"])
    else:
        h = F.gelu(x @ p["mlp/w_up"], approximate="tanh")
    return h @ p["mlp/w_down"]
