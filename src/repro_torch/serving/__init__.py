from repro_torch.serving.adapters import (DenseCacheAdapter, KVCacheAdapter,
                                          PagedCacheAdapter,
                                          PagedQ8CacheAdapter, make_adapter)
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        ServeConfig)

__all__ = ["DenseCacheAdapter", "Engine", "KVCacheAdapter",
           "PagedCacheAdapter", "PagedQ8CacheAdapter", "Request",
           "RequestResult", "ServeConfig", "make_adapter"]
