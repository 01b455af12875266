from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_decode_attention_plain)

__all__ = ["paged_decode_attention", "paged_decode_attention_plain"]
