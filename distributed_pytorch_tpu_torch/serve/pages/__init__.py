"""serve/pages: the paged, prefix-shared KV cache of the serving engine.

KV lives in a refcounted block pool (``pool``), full prompt pages are
keyed in a radix index (``prefix``), and an admitted request reuses
every resident page of its longest matching prefix: tail-only prefill,
LRU eviction of refcount-zero pages, typed back-pressure when the pool
is dry. ``PagedSlotPool`` (``cache``) is the engine's substrate;
``EngineConfig(paged=True)`` turns it on.
"""

from .cache import PagedSlotPool
from .pool import PagePool
from .prefix import PrefixIndex

__all__ = ["PagePool", "PagedSlotPool", "PrefixIndex"]
