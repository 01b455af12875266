"""llama3.2-3b — small llama3 dense decoder. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3.2-3b", family="dense",
        citation="hf:meta-llama/Llama-3.2-1B",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        attention="gqa", activation="swiglu", norm="rmsnorm",
        rope_theta=500_000.0, tie_embeddings=True,
        long_context_mode="sliding_window",
        tp=8, sp=2,
    )
