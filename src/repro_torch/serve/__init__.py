"""Serving tier: the paged KV allocator, the continuous-batching scheduler,
host-side sampling with the reference's random stream, and the engine."""
from .engine import DecodeSync, Request, ServeEngine  # noqa: F401
from .kv_cache import (NULL_BLOCK, BlockAllocator, DoubleFreeError, KVCacheOOM,  # noqa: F401
                       StaleBlockError, block_table_view)
from .scheduler import DECODE, PREFILL, Scheduler  # noqa: F401
