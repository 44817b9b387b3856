"""Growable float32 ring buffer in numpy: the plain version of
``native_lib.RingBuffer``, which the streaming pipeline's rolling audio
buffer uses and tests hold to this one.

One preallocated array with a head and a size, doubled when a write does
not fit. A write copies only the new samples, so appending a
0.05 s chunk costs the same at any buffer length; ``peek`` copies what it
returns, ``discard`` and ``clear`` move the head only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RingBuffer:
    """FIFO of float32 samples: ``write``, ``len``, ``peek``, ``discard``,
    ``clear``, with ``native_lib.RingBuffer``'s clamping."""

    def __init__(self, capacity: int = 1 << 18):
        self._buf = np.empty(max(1, int(capacity)), np.float32)
        self._head = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def _grow(self, need: int) -> None:
        cap = len(self._buf)
        while cap < need:
            cap *= 2
        data = self.peek()
        self._buf = np.empty(cap, np.float32)
        self._buf[: len(data)] = data
        self._head = 0

    def write(self, samples: np.ndarray) -> None:
        x = np.asarray(samples, dtype=np.float32).reshape(-1)
        n = len(x)
        if n == 0:
            return
        if self._size + n > len(self._buf):
            self._grow(self._size + n)
        cap = len(self._buf)
        tail = (self._head + self._size) % cap
        first = min(n, cap - tail)
        self._buf[tail: tail + first] = x[:first]
        self._buf[: n - first] = x[first:]
        self._size += n

    def peek(self, n: Optional[int] = None, offset: int = 0) -> np.ndarray:
        """A copy of ``n`` samples (all when None) from ``offset``, clamped
        to what the buffer holds."""
        if offset < 0:
            raise ValueError(f"offset {offset} < 0")
        total = self._size
        n = total - offset if n is None else min(n, total - offset)
        n = max(n, 0)
        out = np.empty(n, dtype=np.float32)
        if n == 0:
            return out
        cap = len(self._buf)
        start = (self._head + offset) % cap
        first = min(n, cap - start)
        out[:first] = self._buf[start: start + first]
        out[first:] = self._buf[: n - first]
        return out

    def discard(self, n: int) -> None:
        """Drop the oldest ``n`` samples (all of them when ``n`` is larger)."""
        n = min(max(int(n), 0), self._size)
        self._head = (self._head + n) % len(self._buf)
        self._size -= n

    def clear(self) -> None:
        self._head = 0
        self._size = 0
