from repro_torch.kernels.page_copy.ops import (gather_pages, gather_pages_plain,
                                              scatter_pages,
                                              scatter_pages_plain)

__all__ = ["gather_pages", "gather_pages_plain", "scatter_pages",
           "scatter_pages_plain"]
