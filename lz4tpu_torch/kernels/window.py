"""The slide of linked frames' carry-over windows after a wave of
``decompress_frames_parallel``: the CUDA kernel (one launch a wave group,
``csrc/window.cu``) and its plain version.

The JAX package slides each frame's window on the host, as bytes
(``lz4tpu/parallel/pipeline.py``, ``decompress_frames_parallel``); the port
keeps the windows on the card, one right-aligned 64 KiB row a frame.

Tensor contract of ``push_windows``:

* ``old`` (N, 65536) uint8 rows of a wave, right-aligned windows, and
  ``old_len`` (N,) int32 their lengths;
* ``data`` (N, D) uint8 rows of the wave's new bytes, ``lens`` (N,) int32
  (at most D each);
* ``dest`` (N,) int32: the row of each frame in the next wave, or -1 where
  the frame has no next block;
* ``new`` (M, 65536) uint8 and ``new_len`` (M,) int32, another tensor than
  ``old``: for each ``r`` with ``dest[r] >= 0``, row ``dest[r]`` becomes
  the last 64 KiB of ``old[r] | data[r, :lens[r]]`` and its length
  ``min(old_len[r] + lens[r], 65536)``.  Other rows are left as they are.
"""

from __future__ import annotations

import torch

from .. import build
from ..runtime import KernelStats, stream_handle
from ..spec.block import WINDOW_SIZE

KERNEL = KernelStats("push_windows")
SOURCE = "lz4tpu_torch/csrc/window.cu"


def _check(old, old_len, data, lens, dest, new, new_len):
    n = old.shape[0]
    for label, t, shape in (("old", old, (n, WINDOW_SIZE)), ("new", new, (new.shape[0],
                                                                          WINDOW_SIZE))):
        if t.dtype != torch.uint8 or tuple(t.shape) != shape or t.stride(1) != 1:
            raise ValueError(f"push_windows: {label} must be ({shape[0]}, {WINDOW_SIZE}) uint8 "
                             "rows")
    if new.data_ptr() % 16 or new.stride(0) % 16:
        raise ValueError("push_windows: new must be rows of whole 16-byte units")
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != n or data.stride(1) != 1:
        raise ValueError(f"push_windows: data must be ({n}, D) uint8 rows")
    for label, t, m in (("old_len", old_len, n), ("lens", lens, n), ("dest", dest, n),
                        ("new_len", new_len, new.shape[0])):
        if t.dtype != torch.int32 or tuple(t.shape) != (m,) or not t.is_contiguous():
            raise ValueError(f"push_windows: {label} must be a contiguous ({m},) int32 tensor")
    for label, t in (("old_len", old_len), ("data", data), ("lens", lens), ("dest", dest),
                     ("new", new), ("new_len", new_len)):
        if t.device != old.device:
            raise ValueError(f"push_windows: {label} is on {t.device}, old on {old.device}")


def push_windows(old, old_len, data, lens, dest, new, new_len) -> None:
    """Slide the windows of a wave's rows into the next wave's rows (see
    the module's contract); the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Not waited for."""
    _check(old, old_len, data, lens, dest, new, new_len)
    if old.is_cuda:
        lib = build.load()
        with torch.cuda.device(old.device):
            h = KERNEL.begin()
            rc = lib.lz4t_push_windows(
                old.data_ptr(), old.stride(0), old_len.data_ptr(), data.data_ptr(),
                data.stride(0), lens.data_ptr(), dest.data_ptr(), new.data_ptr(), new.stride(0),
                new_len.data_ptr(), old.shape[0], stream_handle())
            KERNEL.end(h)
        build.check(rc, "lz4t_push_windows")
    elif old.device.type == "cpu":
        push_windows_plain(old, old_len, data, lens, dest, new, new_len)
    else:
        raise ValueError(f"push_windows: unsupported device {old.device}")


def push_windows_plain(old, old_len, data, lens, dest, new, new_len) -> None:
    """Plain version of ``push_windows`` (same contract), in torch."""
    rows = torch.nonzero(dest >= 0).flatten()
    if not len(rows):
        return
    w = WINDOW_SIZE
    n = lens[rows].to(torch.int64)
    # byte j of the new window is byte t = j + n of ``old[r] | data[r, :n]``
    t = n[:, None] + torch.arange(w, device=old.device)[None, :]
    from_old = torch.gather(old[rows], 1, t.clamp(max=w - 1))
    from_data = torch.gather(data[rows], 1, (t - w).clamp(min=0, max=data.shape[1] - 1))
    at = dest[rows].to(torch.int64)
    new[at] = torch.where(t < w, from_old, from_data)
    new_len[at] = torch.clamp(old_len[rows] + lens[rows], max=w)
