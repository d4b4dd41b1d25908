from repro_torch.serving.adapters import (DenseCacheAdapter, KVCacheAdapter,
                                          make_adapter)
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        ServeConfig)

__all__ = ["DenseCacheAdapter", "Engine", "KVCacheAdapter", "Request",
           "RequestResult", "ServeConfig", "make_adapter"]
