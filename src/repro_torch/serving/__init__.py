from repro_torch.serving.adapters import (DenseCacheAdapter, KVCacheAdapter,
                                          PagedCacheAdapter,
                                          PagedQ8CacheAdapter, make_adapter)
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        ServeConfig)
from repro_torch.serving import kv_cache
from repro_torch.serving import paged_kv_cache
from repro_torch.serving.sched import SchedConfig, Schedule, ScheduledEngine

__all__ = ["DenseCacheAdapter", "Engine", "KVCacheAdapter",
           "PagedCacheAdapter", "PagedQ8CacheAdapter", "Request",
           "RequestResult", "SchedConfig", "Schedule", "ScheduledEngine",
           "ServeConfig", "kv_cache", "make_adapter", "paged_kv_cache"]
