"""Device selection and per-kernel launch accounting.

Every public entry point of the port takes ``device=None``, which means
``"cuda"``: without a card that is an error, never a quiet fall back to
the CPU.  Pass ``device="cpu"`` to run the kernels' plain versions.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


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


class KernelStats:
    """Launch count (and optional CUDA-event timing) of one kernel.

    ``launches`` goes up by one at each launch of the CUDA kernel and
    nowhere else.  With ``reset(timing=True)`` each launch is bracketed by
    CUDA events; ``elapsed_ms()`` synchronises and sums them.
    """

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._events = None

    def reset(self, timing: bool = False) -> None:
        self.launches = 0
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
