"""Device selection and the port's instrumentation: per-kernel launch
accounting, spans and counters.

Every public entry point of the port takes ``device=None``, which means
``"cuda"``: without a card that is an error, never a quiet fall back to
the CPU.  Pass ``device="cpu"`` to run the kernels' plain versions.

Spans (``span``) name the phases of the frame paths in a caller's
``torch.profiler`` trace, on the profiler's clock beside the card's
kernels and copies; with no profiler recording a span is one check.
Counters (``stats()``, ``reset_stats()``) are integer adds at the same
boundaries, always on.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import warnings

import numpy as np
import torch
from torch.autograd.profiler import record_function


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lz4tpu_torch: device=None means 'cuda', but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain (CPU) versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"lz4tpu_torch: unsupported device {dev}")
    return dev


_LOCK = threading.Lock()
#: every ``KernelStats``, in the order they were built
_KERNELS: list = []
#: each kernel's ``launches`` at the last ``reset_stats()``
_LAUNCHES_AT_RESET: dict = {}


class KernelStats:
    """Launch count (and optional CUDA-event timing) of one kernel.

    ``launches`` goes up by one at each launch of the CUDA kernel and
    nowhere else, and is never zeroed: a count over a span of work is a
    difference.  With ``reset(timing=True)`` each launch is bracketed by
    CUDA events; ``elapsed_ms()`` synchronises and sums them.  Each one
    registers itself for ``stats()`` when it is built.
    """

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._events = None
        with _LOCK:
            _KERNELS.append(self)

    def reset(self, timing: bool = False) -> None:
        """Drop the timed launches, and time the next ones with ``timing``."""
        self._events = [] if timing else None

    def begin(self):
        self.launches += 1
        if self._events is None:
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        return start

    def end(self, start) -> None:
        if start is not None:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self._events.append((start, stop))

    def elapsed_ms(self) -> float:
        if not self._events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` as a span of the current thread
    (``record_function``) while torch's profiler records, and does nothing
    otherwise: the check costs under 1 us, an unrecorded
    ``record_function`` about 10 us.  Spans are opened per phase of a
    call, never per block."""
    return record_function(name) if _recording() else _OFF


#: the frame entry points whose calls ``stats()`` counts
ENTRIES = ("compress_frame", "decompress_frame", "decompress_frames")
#: the counters of ``stats()`` besides ``calls`` and ``launches``
COUNTERS = ("uploads", "upload_bytes", "fetches", "fetch_bytes", "staging_allocs",
            "staging_alloc_bytes", "staging_waits", "content_hashes_beside",
            "content_hash_waits", "linked_frames", "waves", "wave_launches",
            "window_pushes", "big_blocks_v4", "compress_seams", "compress_seams_taken_over")
_CALLS = dict.fromkeys(ENTRIES, 0)
_COUNTS = dict.fromkeys(COUNTERS, 0)


def count(**adds: int) -> None:
    """Add to the counters named."""
    with _LOCK:
        for name, n in adds.items():
            _COUNTS[name] += n


def traced(name: str):
    """Decorator: each call of the function runs in the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def entry(name: str):
    """Decorator of a frame entry point: each call counts under ``name`` in
    ``stats()["calls"]`` and runs in the span ``lz4t.<name>``."""

    label = f"lz4t.{name}"

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _LOCK:
                _CALLS[name] += 1
            with span(label):
                return fn(*args, **kwargs)

        return call

    return wrap


def stats() -> dict:
    """A snapshot of the counters since the process started or
    ``reset_stats()``: ``calls`` by entry point, ``launches`` by kernel
    (the CUDA kernels'; plain versions launch nothing), and ``COUNTERS``;
    besides, ``device_bytes_peak``, torch's peak of allocated device
    memory on the busiest card since the process started (0 without one),
    which ``reset_stats()`` leaves alone."""
    with _LOCK:
        out = {"calls": dict(_CALLS), **_COUNTS}
        out["launches"] = {k.name: k.launches - _LAUNCHES_AT_RESET.get(k.name, 0)
                           for k in _KERNELS}
    out["device_bytes_peak"] = max(
        (torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())),
        default=0) if torch.cuda.is_initialized() else 0
    return out


def reset_stats() -> None:
    """Zero every counter of ``stats()``: its launches count from each
    kernel's ``KernelStats.launches`` now.  Leaves ``KernelStats`` and
    torch's own memory statistics (``device_bytes_peak``) as they are."""
    with _LOCK:
        for d in (_CALLS, _COUNTS):
            for k in d:
                d[k] = 0
        _LAUNCHES_AT_RESET.update((k.name, k.launches) for k in _KERNELS)


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the int the C launchers take."""
    return torch.cuda.current_stream().cuda_stream


def host_u8(data) -> torch.Tensor:
    """A read-only bytes-like object as a 1-D uint8 CPU tensor, without a
    copy.  The tensor must not be written."""
    arr = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only buffer
        return torch.from_numpy(arr)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
