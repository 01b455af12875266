from repro_torch.serving.engine import (Request, Response, ServingEngine,
                                        decode_steps)
from repro_torch.serving.paged_kv import KVSession, PagedKVCache

__all__ = ["Request", "Response", "ServingEngine", "decode_steps",
           "KVSession", "PagedKVCache"]
