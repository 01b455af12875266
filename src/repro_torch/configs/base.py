"""Model configuration for the PyTorch port.

The port's own copy of the configuration fields the dense GQA family needs
(the reference keeps the full multi-family dataclass in
``repro/configs/base.py``).  Each architecture lives in its own
``configs/<arch>.py`` module exposing ``make_config() -> ModelConfig``;
``get_config(arch_id)`` resolves through the registry and
``tiny_config(cfg)`` derives the reduced CPU-test variant (2 layers,
d_model <= 256) exactly as the reference does.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                          # dense (only family ported so far)
    citation: str

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    attention: str = "gqa"
    rope_theta: float = 10_000.0
    rope_mode: str = "full"              # full | 2d | none
    max_position: int = 1 << 20
    long_context_mode: str = "sliding_window"
    sliding_window: int = 4096

    activation: str = "swiglu"           # swiglu | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    tp: int = 1
    sp: int = 1
    kv_page_size: int = 16

    def __post_init__(self):
        if self.attention == "gqa" and self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference's sharding
        padding); logical vocab stays ``vocab_size``."""
        return -(-self.vocab_size // 256) * 256


ARCH_IDS = ("llama3.2-3b",)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch_id]).make_config()
    if cfg.arch_id != arch_id:
        raise ValueError(f"config module for {arch_id!r} built {cfg.arch_id!r}")
    return cfg


def tiny_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=256, f32."""
    d = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = (heads // kv) * kv or kv
    return replace(
        cfg, num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
        head_dim=d // max(heads, 1),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_position=2_048, sliding_window=64, kv_page_size=8,
        tp=1, sp=1, dtype="float32")
