"""Checksum backend: the C xxHash32 built beside the CUDA kernels when the
work runs on the card, the pure-Python one otherwise."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec.xxhash32 import XXHash32


def _pointer(data):
    """(ctypes-passable pointer, length, keep-alive) for bytes-like data."""
    if isinstance(data, bytes):
        return data, len(data), data
    arr = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr.size, arr


class CXXHash32:
    """Streaming xxHash32 over the library's C state machine."""

    def __init__(self, seed: int = 0):
        from .. import build

        self._lib = build.load()
        self._seed = seed
        self._state = ctypes.create_string_buffer(self._lib.lz4t_xxh32_state_size())
        self._lib.lz4t_xxh32_init(self._state, seed)

    def update(self, data) -> "CXXHash32":
        ptr, n, _keep = _pointer(data)
        self._lib.lz4t_xxh32_update(self._state, ptr, n)
        return self

    def digest(self) -> int:
        return int(self._lib.lz4t_xxh32_digest(self._state, self._seed))


def make_hasher(seed: int = 0, device="cpu"):
    """Streaming xxHash32 with ``update``/``digest``: C on ``cuda``, pure
    Python on ``cpu``."""
    if torch.device(device).type == "cuda":
        return CXXHash32(seed)
    return XXHash32(seed)


def engine_hash_device() -> str:
    """Checksum backend for a frame whose block engine is a callable (it
    names no device): the C one where there is a card to build it for."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def xxh32(data, seed: int = 0, device="cpu") -> int:
    """One-shot xxHash32 with the backend of ``make_hasher``."""
    return make_hasher(seed, device).update(data).digest()
