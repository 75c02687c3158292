"""Entry points of the port for a harness that runs it (counterpart of
the JAX package's ``__graft_entry__.py``).

* ``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is one step
  of the main decode path, decode128 over a batch of eight raw blocks of
  2-3 KiB at a 16 KiB output limit, and ``example_args`` the batch's
  tensors on the device: ``fn(*example_args)`` gives ``(out, out_len,
  status)``.
* ``dryrun_multichip(n_devices, devices=None)`` runs one sharded compress
  and decompress step on a mesh of ``n_devices`` cards (or of ``devices``,
  a device named more than once allowed: ``["cpu"] * k`` on the CPU): an
  independent frame, a ``parallel_linked`` frame, and one linked frame a
  mesh entry wave-decoded by ``decompress_frames_parallel``.  With fewer
  cards than ``n_devices`` and no ``devices`` it raises: unlike the JAX
  package's, it never falls back to a CPU mesh.
"""

from __future__ import annotations

import functools

import numpy as np

from . import native
from .kernels.decode128 import decode128
from .kernels.pack import pack_prefixes, pack_rows
from .parallel.mesh import make_mesh
from .parallel.pipeline import (
    compress_frame_parallel,
    decompress_frame_parallel,
    decompress_frames_parallel,
)
from .runtime import resolve_device
from .spec.table import U32Table

EXAMPLE_LIMIT = 1 << 14


def example_payloads() -> list[bytes]:
    """Eight seeded payloads of 2,048 + 128 i bytes: a random 64-byte motif
    repeated, with random 24-byte runs between the repeats."""
    rng = np.random.default_rng(0)
    payloads = []
    for i in range(8):
        motif = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
        parts = []
        while sum(map(len, parts)) < 2048 + 128 * i:
            parts.append(motif * rng.integers(1, 5))
            parts.append(bytes(rng.integers(0, 256, 24, dtype=np.uint8)))
        payloads.append(b"".join(parts)[: 2048 + 128 * i])
    return payloads


def _example_batch():
    """(rows, lengths, capacity): the payloads' greedy parse, one per row of
    a (8, 4096) uint8 array."""
    comp = [native.compress_block(p, 0, U32Table()) for p in example_payloads()]
    cap = 4096
    arr = np.zeros((len(comp), cap), np.uint8)
    lens = np.zeros(len(comp), np.int32)
    for i, c in enumerate(comp):
        arr[i, : len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    return arr, lens, cap


def entry(device=None):
    """``(fn, example_args)``: decode128 over the example batch's rows on
    ``device`` (``None``: the card), at a 16 KiB output limit."""
    dev = resolve_device(device)
    arr, lens, _ = _example_batch()
    comp, comp_len = pack_rows([arr[i, : lens[i]].tobytes() for i in range(len(lens))], dev)
    prefix, prefix_len = pack_prefixes(None, len(lens), dev)
    fn = functools.partial(decode128, limit=EXAMPLE_LIMIT)
    return fn, (comp, comp_len, prefix, prefix_len)


def dryrun_data(n_devices: int) -> bytes:
    """The dry run's input: a seeded 256-byte motif repeated, 307,200 B at
    most (three 64 KiB blocks a mesh entry and 777 B, where it reaches)."""
    rng = np.random.default_rng(42)
    motif = bytes(rng.integers(0, 256, 256, dtype=np.uint8))
    return (motif * 1200)[: n_devices * 3 * 65536 + 777]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One sharded compress and decompress step on an ``n_devices`` mesh
    (``devices``, if given, are its entries); raises on a round trip that
    does not give back its input.  Returns the frames it made:
    ``independent``, ``linked`` and ``frames`` (one linked frame a mesh
    entry)."""
    if devices is not None and len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip: {len(devices)} devices for a mesh of {n_devices}")
    mesh = make_mesh(n_devices, devices=devices)
    data = dryrun_data(n_devices)

    # independent blocks: a range of them a mesh entry, the frame byte-exact
    frame = compress_frame_parallel(data, block_size=1 << 16, mesh=mesh)
    if decompress_frame_parallel(frame, mesh=mesh) != data:
        raise RuntimeError("dryrun_multichip: independent-mode mesh round trip failed")

    # parallel-linked: each range's copy carries the 64 KiB before it
    frame_linked = compress_frame_parallel(data, block_size=1 << 16, mesh=mesh,
                                           parallel_linked=True)
    if decompress_frame_parallel(frame_linked, mesh=mesh) != data:
        raise RuntimeError("dryrun_multichip: parallel-linked mesh round trip failed")

    # many linked frames' chains decoded in waves, block w of every frame a wave
    per = len(data) // n_devices
    sub = [data[i * per : (i + 1) * per] for i in range(n_devices)]
    linked_frames = [compress_frame_parallel(s, block_size=1 << 16, mesh=mesh,
                                             parallel_linked=True) for s in sub]
    if decompress_frames_parallel(linked_frames, mesh=mesh) != sub:
        raise RuntimeError("dryrun_multichip: linked-frame wave decode failed")
    print(f"dryrun_multichip({n_devices}) on {[str(d) for d in mesh.devices]}: ok - independent "
          f"{len(frame)}B, parallel-linked {len(frame_linked)}B from {len(data)}B, "
          f"{len(linked_frames)} linked chains wave-decoded")
    return {"independent": frame, "linked": frame_linked, "frames": linked_frames}


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out, out_len, status = fn(*args)
    print("entry: statuses", status.cpu().tolist(), "lengths", out_len.cpu().tolist())
    dryrun_multichip(torch.cuda.device_count())
