"""State carried across the two packages: the encoder tables.

The codec has no weights; its state is the greedy parser's hash table,
which linked-mode byte parity rests on.  The port keeps a batch of tables
as one ``(N, S)`` int32 tensor (the slots' bits; ``S`` = 4096 for U32
tables, 8192 for U16) plus an ``(N,)`` int32 tensor of table offsets.

``tables_from_jax`` takes the JAX package's ``U16Table``/``U32Table``
objects (or anything with ``.dict`` and ``.offset``, such as the port's
own tables), or plain ``(dict ndarray, offset)`` pairs, so the port itself
imports nothing of the JAX package.  ``tables_to_numpy`` goes back.

The lane compressor's tables are packed ``pos17 | tag15 << 17`` entries.
The JAX package holds a batch of at most 128 of them transposed, one
column a lane: ``(1 << hashlog, 128)`` int32.  The port holds one row a
block, ``(N, 1 << hashlog)`` int32, for any N; ``lane_tables_from_jax`` and
``lane_tables_to_jax`` go between the two, so the port's window priming
can be held equal to the JAX package's.

The decoders (``decode128``, ``decode_v4``, ``decode_big``, ``decode_v3``)
and the linked-frame paths carry no state of their own across the two
packages: a carry-over window is plain bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .spec.table import U16_SLOTS, U32_SLOTS

LANES = 128  # blocks a batch of the JAX package's lane tables holds
LANE_SENTINEL = 0x1FFFF  # an empty packed slot (kernels/compress128.py)


def tables_from_jax(tables):
    """Table objects or ``(dict, offset)`` pairs -> ``(tables, offsets)``
    tensors on the CPU: ``(N, S)`` int32 slot bits and ``(N,)`` int32."""
    dicts, offsets = [], []
    for t in tables:
        d, off = (t.dict, t.offset) if hasattr(t, "dict") else t
        d = np.asarray(d)
        if d.size not in (U32_SLOTS, U16_SLOTS):
            raise ValueError(f"encoder table of {d.size} slots")
        dicts.append(d.astype(np.uint32).view(np.int32))
        offsets.append(int(off))
    if len({d.size for d in dicts}) > 1:
        raise ValueError("a batch mixes U16 and U32 tables")
    if not dicts:
        return torch.zeros((0, U32_SLOTS), dtype=torch.int32), torch.zeros(0, dtype=torch.int32)
    return (
        torch.from_numpy(np.stack(dicts)),
        torch.tensor(offsets, dtype=torch.int32),
    )


def tables_to_numpy(tables: torch.Tensor, offsets=None):
    """``(N, S)`` int32 slot tensor (+ offsets) -> ``[(dict, offset), ...]``
    with ``dict`` uint16 (S = 8192) or uint32 (S = 4096), as the table
    classes of both packages hold them."""
    arr = tables.detach().cpu().numpy()
    dtype = np.uint16 if arr.shape[1] == U16_SLOTS else np.uint32
    if offsets is None:
        offs = [0] * arr.shape[0]
    else:
        offs = [int(o) for o in torch.as_tensor(offsets).cpu().tolist()]
    return [(arr[i].view(np.uint32).astype(dtype), offs[i]) for i in range(arr.shape[0])]


def lane_tables_from_jax(tables, n_blocks: int) -> torch.Tensor:
    """The JAX package's transposed ``(1 << hashlog, 128)`` packed lane
    tables (numpy, from ``prime_tables_packed`` or
    ``native.prime_tables_native``) -> the port's ``(n_blocks, 1 <<
    hashlog)`` int32 tensor on the CPU: block ``i`` is lane ``i``."""
    arr = np.asarray(tables)
    if arr.ndim != 2 or arr.shape[1] != LANES or arr.dtype != np.int32:
        raise ValueError(f"lane tables must be (1 << hashlog, {LANES}) int32, got "
                         f"{arr.shape} {arr.dtype}")
    if not 0 <= n_blocks <= LANES:
        raise ValueError(f"a batch of lane tables holds at most {LANES} blocks")
    return torch.from_numpy(np.ascontiguousarray(arr.T[:n_blocks]))


def lane_tables_to_jax(tables: torch.Tensor) -> np.ndarray:
    """``(N, 1 << hashlog)`` int32 lane tables, N at most 128 -> the JAX
    package's ``(1 << hashlog, 128)`` layout; unused lanes hold the
    sentinel."""
    arr = tables.detach().cpu().numpy()
    if arr.ndim != 2 or arr.shape[0] > LANES or arr.dtype != np.int32:
        raise ValueError(f"lane tables must be (N <= {LANES}, 1 << hashlog) int32")
    out = np.full((arr.shape[1], LANES), LANE_SENTINEL, np.int32)
    out[:, : arr.shape[0]] = arr.T
    return out
