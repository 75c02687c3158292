"""The device mesh: the cards of this process, and the processes of a run.

Counterpart of ``lz4tpu/parallel/mesh.py``.  The frame format's seam is
the block: independent blocks are self-contained problems, and a linked
block needs only the 64 KiB of input before it.  A mesh is a 1-D list of
this process's devices along one ``blocks`` axis; a frame's blocks are cut
into one contiguous range per entry (``shard_bounds``), each range is
copied to its card with the bytes its first block may look back at (the
counterpart of the JAX package's ring halo, which carries input bytes
too), and every entry's kernels run on that card's own stream.  No
collective touches the data.

Across processes the runner splits the corpus by index
(``runner.run_sharded_compress``); ``initialize_distributed`` is the
rendezvous that gives each process its rank and the count, as
``jax.distributed`` does for the JAX package.  Gloo serves, because nothing
is exchanged but that.

A mesh may name a device more than once: ``["cpu"] * 4`` is the tests'
virtual mesh, as the JAX package's tests run on eight virtual CPU devices,
and ``["cuda:0"] * 4`` drives the sharding on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..runtime import resolve_device

BLOCK_AXIS = "blocks"


@dataclass(frozen=True)
class Mesh:
    """An immutable 1-D sequence of ``torch.device`` along ``BLOCK_AXIS``."""

    devices: tuple

    def __post_init__(self):
        devices = tuple(resolve_device(d) for d in self.devices)
        if not devices:
            raise ValueError("lz4tpu_torch: a mesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            # a CPU entry would run the plain versions beside the cards
            raise ValueError("lz4tpu_torch: a mesh is all cards or all CPU, not both")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """The entries along ``BLOCK_AXIS`` (a JAX mesh's
        ``shape[BLOCK_AXIS]``)."""
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ``blocks`` mesh over ``devices``, or over every card this
    process sees (the first ``n_devices`` of them, if given).  Without a
    card it raises: there is no fall back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            resolve_device(None)  # raises: device=None means 'cuda'
        if n_devices is not None:
            if not 0 < n_devices <= count:
                raise ValueError(f"lz4tpu_torch: {n_devices} devices asked for, "
                                 f"{count} cards present")
            count = n_devices
        devices = [f"cuda:{i}" for i in range(count)]
    return Mesh(devices)


def local_mesh() -> Mesh:
    """A mesh over THIS process's cards.  Each process of a multi-process
    run compresses its own shards of the corpus over its own cards, so no
    traffic crosses between processes."""
    return make_mesh()


def shard_bounds(n_items: int, k: int) -> list[tuple[int, int]]:
    """One contiguous ``(lo, hi)`` range of ``n_items`` for each of ``k``
    mesh entries, in order, the sizes differing by at most one (the first
    ranges take the remainder); entries beyond ``n_items`` get empty
    ranges.  The JAX package shards with a ``NamedSharding`` instead, after
    padding the item count to a multiple of ``k``."""
    q, r = divmod(n_items, k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> tuple[int, int]:
    """Join a multi-process run: ``torch.distributed.init_process_group``
    with ``init_method="tcp://{coordinator_address}"``, ``world_size`` and
    ``rank``; the backend is ``"gloo"`` unless ``backend=`` says otherwise,
    since the runner needs only the rendezvous.  Returns ``(rank,
    world_size)``, the runner's ``(process_index, process_count)``.  Call
    it once a process; a run of one process never needs it."""
    import torch.distributed as dist

    kwargs.setdefault("backend", "gloo")
    if coordinator_address is not None:
        kwargs.setdefault("init_method", f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs.setdefault("world_size", num_processes)
    if process_id is not None:
        kwargs.setdefault("rank", process_id)
    dist.init_process_group(**kwargs)
    return dist.get_rank(), dist.get_world_size()
