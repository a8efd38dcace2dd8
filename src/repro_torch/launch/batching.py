"""Batching helpers of the serving layer: batch-size rounding and the
LRU the engine factory keeps its models, parameters and engines in.
(The reference's MicroBatcher is not ported yet.)"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


def round_batch(n: int, max_batch: int, mode: str = "pow2") -> int:
    """Padded batch size for ``n`` live items: "pow2" rounds up to the
    next power of two (<= max_batch); "none" keeps the exact size."""
    if mode == "none":
        return n
    if mode == "pow2":
        b = 1
        while b < n:
            b *= 2
        return min(b, max_batch) if n <= max_batch else n
    raise ValueError(f"unknown batch rounding mode: {mode}")


class LRUCache:
    """key -> value with least-recently-used eviction at ``capacity``
    (0 or negative = unbounded)."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            return None

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while self.capacity > 0 and len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)
