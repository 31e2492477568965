"""Preallocated activation storage (counterpart of
``apex_tpu/transformer/tensor_parallel/memory.py``): the reference's
``MemoryBuffer`` / ``RingMemBuffer``.

JAX keeps the shape accounting (typed requests out of one element budget,
an error on overflow) and hands out fresh arrays, as XLA owns
allocation. The caching allocator leaves the port the same choice, but
a preallocated buffer costs nothing to keep: :meth:`MemoryBuffer.get`
returns a zero-copy view into one flat tensor, as the reference does.
"""

from __future__ import annotations

import logging
from typing import List

import torch

_LOG = logging.getLogger(__name__)


class MemoryBuffer:
    """A flat ``numel`` budget of ``dtype``: :meth:`get` carves the next
    view of ``shape``, :meth:`reset` rewinds."""

    def __init__(self, name: str, numel: int, dtype, track_usage: bool = False,
                 device=None):
        self.name = name
        self.numel = numel
        self.dtype = dtype
        self.track_usage = track_usage
        self.data = torch.zeros(numel, dtype=dtype, device=device)
        self.in_use_numel = 0
        self.max_used = 0

    def reset(self):
        self.in_use_numel = 0

    def is_in_use(self) -> bool:
        return self.in_use_numel > 0

    def numel_in_use(self) -> int:
        return self.in_use_numel

    def get(self, shape) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= s
        if self.in_use_numel + n > self.numel:
            raise RuntimeError(
                f"MemoryBuffer {self.name!r} overflow: requested {n} "
                f"elements, {self.numel - self.in_use_numel} free of "
                f"{self.numel}")
        view = self.data[self.in_use_numel:self.in_use_numel + n].view(shape)
        self.in_use_numel += n
        if self.track_usage:
            self.max_used = max(self.max_used, self.in_use_numel)
        return view

    def print_average_usage(self):
        _LOG.info("MemoryBuffer %s: peak %d / %d elements", self.name,
                  self.max_used, self.numel)


class RingMemBuffer:
    """A rotating ring of :class:`MemoryBuffer`\\ s."""

    def __init__(self, name: str, num_buffers: int, numel: int, dtype,
                 track_usage: bool = False, device=None):
        self.num_buffers = num_buffers
        self.buffers: List[MemoryBuffer] = [
            MemoryBuffer(f"{name} {i}", numel, dtype, track_usage, device)
            for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self) -> MemoryBuffer:
        self._index = (self._index + 1) % self.num_buffers
        buf = self.buffers[self._index]
        if buf.is_in_use():
            raise RuntimeError("buffer is already in use")
        return buf
