"""Checksum backend: the native engine's C xxHash32 (``lz4tpu_torch.native``)
for work on the card and on the ``"native"`` engine, the pure-Python one
on the CPU."""

from __future__ import annotations

import torch

from .. import native
from ..spec.xxhash32 import XXHash32


def make_hasher(seed: int = 0, device="cpu"):
    """Streaming xxHash32 with ``update``/``digest``: the native engine's
    on ``cuda`` and ``"native"``, pure Python on ``cpu``."""
    if device == "native" or torch.device(device).type == "cuda":
        return native.XXHash32(seed)
    return XXHash32(seed)


def xxh32(data, seed: int = 0, device="cpu") -> int:
    """One-shot xxHash32 with the backend of ``make_hasher``."""
    return make_hasher(seed, device).update(data).digest()
