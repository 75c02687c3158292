"""Checksum backend: the native engine's C xxHash32 (``lz4tpu_torch.native``)
for work on the card and on the ``"native"`` engine, the pure-Python one
on the CPU.

``content_hash`` hashes a frame's content beside the rest of a call: on
the native backend, content of ``BESIDE_MIN`` bytes or more is hashed on a
helper thread, in one native call that holds no interpreter lock, while
the calling thread uploads, launches, waits or joins; ``digest()`` waits
for it.  Shorter content, and the pure-Python hasher (which holds the
lock), hash inline when ``digest()`` is asked for.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import native, runtime
from ..spec.xxhash32 import XXHash32

#: content from which ``content_hash`` hashes on a helper thread: about
#: where handing the hash over to a helper idle between calls costs the
#: caller as much as hashing it inline (``PERF.md`` §6)
BESIDE_MIN = 640 << 10


def native_backend(device) -> bool:
    """Whether ``device`` hashes with the native engine: ``cuda`` and
    ``"native"``; ``cpu`` hashes in pure Python."""
    return device == "native" or torch.device(device).type == "cuda"


def make_hasher(seed: int = 0, device="cpu"):
    """Streaming xxHash32 with ``update``/``digest``: the native engine's
    on ``cuda`` and ``"native"``, pure Python on ``cpu``."""
    if native_backend(device):
        return native.XXHash32(seed)
    return XXHash32(seed)


def xxh32(data, seed: int = 0, device="cpu") -> int:
    """One-shot xxHash32 with the backend of ``make_hasher``."""
    return make_hasher(seed, device).update(data).digest()


_POOL = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(native.host_threads(), thread_name_prefix="lz4t-hash")
        return _POOL


def _hash_table(hasher, table) -> int:
    """``hasher``'s digest after the pieces of ``table`` (a
    ``native.buffer_table``): one native call that holds no interpreter
    lock, then the digest."""
    return hasher.update_table(*table).digest()


def _beside(started, hasher, table, pieces) -> int:
    """The helper's task.  It holds ``pieces`` until it returns, so the
    memory ``table`` points into outlives a caller that drops its handle,
    as when it raises before asking for the digest."""
    started.set()
    return _hash_table(hasher, table)


class _Inline:
    """A content hash computed on the calling thread when it is asked for."""

    def __init__(self, pieces, seed, device):
        self._pieces, self._seed, self._device = pieces, seed, device

    def digest(self) -> int:
        hasher = make_hasher(self._seed, self._device)
        for p in self._pieces:
            hasher.update(p)
        return hasher.digest()


class _Beside:
    """A content hash running on a helper thread.  The helper's task holds
    every piece until the hash has ended: a piece may be a view into
    staging, which goes back to its pool when its last view dies.

    The calling thread builds the hasher and the pieces' table, and goes
    on only once the helper has started: from there the helper needs the
    interpreter lock only for the digest, so a join over ``memoryview``
    pieces, which holds the lock while it copies, does not hold the hash
    back."""

    def __init__(self, pieces, seed):
        started = threading.Event()
        self._future = _pool().submit(_beside, started, native.XXHash32(seed),
                                      native.buffer_table(pieces), pieces)
        started.wait()

    def digest(self) -> int:
        if not self._future.done():
            runtime.count(content_hash_waits=1)
        return self._future.result()


def content_hash(pieces, device, seed: int = 0):
    """The xxHash32 of the bytes-like ``pieces`` one after another, as a
    handle whose ``digest()`` returns it (and raises what the hash raised).
    With the native backend and ``BESIDE_MIN`` bytes or more the hash
    starts now on a helper thread (counted as ``content_hashes_beside``);
    else it runs inline in ``digest()``.  The pieces must not change until
    ``digest()`` has returned."""
    pieces = list(pieces)
    if native_backend(device) and sum(memoryview(p).nbytes for p in pieces) >= BESIDE_MIN:
        runtime.count(content_hashes_beside=1)
        return _Beside(pieces, seed)
    return _Inline(pieces, seed, device)
