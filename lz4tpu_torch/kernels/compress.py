"""Raw-block greedy compressor: the CUDA kernel, its plain version, and the
batch and single-block host APIs.

Counterpart of ``lz4tpu/kernels/compress.py``.  The greedy parse of the
reference (``src/raw/compress/mod.rs:147-260``) is serial in what it
decides, not in its work: one block is one warp's parse
(``csrc/compress.cu``), which probes 32 positions of the skip schedule at
once and takes the first hit, the match the serial loop takes.
``parse_plain`` is the serial loop and the specification;
``parse_batched_plain`` follows the kernel's steps and is held equal to it
by the tests.

Tensor contract of ``compress_batch`` (kernel and plain version alike):

* ``data`` (N, C) uint8 — row i holds ``[prefix | block]``, ``n[i]`` bytes;
* ``n``, ``cursor``, ``cap`` (<0: none), ``accel``, ``toff``, ``prime``:
  (N,) int32 per-block scalars (parse start, output cap, acceleration,
  table offset, 1 = prime the table from ``data[:cursor]``);
* ``tables`` (N, S) int32 slot bits, S = 4096 (U32) or 8192 (U16);
* returns ``out`` (N, W) uint8 (zero past ``out_len``), ``out_len``,
  ``status`` (``STATUS_OK`` / ``STATUS_INCOMPRESSIBLE``) and the post-parse
  ``tables`` — mutated up to the abort point on Incompressible, like the
  reference's ``NoPartialWrites``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build, hostpack
from ..runtime import KernelStats, resolve_device, round_up, stream_handle
from ..spec.block import (
    LAST_LITERALS,
    MFLIMIT,
    MINMATCH,
    SKIP_TRIGGER,
    BlockTooBig,
    Incompressible,
    compress_bound,
)
from ..spec.table import U16_SLOTS, U32_SLOTS, U16Table, U32Table, hash_all_u16, hash_all_u32
from ..state import tables_from_jax
from .status import STATUS_INCOMPRESSIBLE, STATUS_OK

KERNEL = KernelStats("compress")
SOURCE = "lz4tpu_torch/csrc/compress.cu"
REPLACES = "lz4tpu/kernels/compress.py:71"


def _check(data, scalars, tables, out_capacity):
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("compress: data must be a contiguous (N, C) uint8 tensor")
    n_blocks = data.shape[0]
    for name, t in scalars.items():
        if t.dtype != torch.int32 or t.shape != (n_blocks,) or not t.is_contiguous():
            raise ValueError(f"compress: {name} must be a contiguous ({n_blocks},) int32 tensor")
        if t.device != data.device:
            raise ValueError(f"compress: {name} is on {t.device}, data on {data.device}")
    if (
        tables.dtype != torch.int32
        or tables.dim() != 2
        or tables.shape[0] != n_blocks
        or tables.shape[1] not in (U32_SLOTS, U16_SLOTS)
        or not tables.is_contiguous()
    ):
        raise ValueError("compress: tables must be a contiguous (N, 4096|8192) int32 tensor")
    if tables.device != data.device:
        raise ValueError(f"compress: tables are on {tables.device}, data on {data.device}")
    if out_capacity <= 0:
        raise ValueError("compress: out_capacity must be positive")


def compress_batch(data, n, cursor, cap, accel, toff, prime, tables, out_capacity=None):
    """Compress a batch of blocks; the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring)."""
    if out_capacity is None:
        out_capacity = round_up(compress_bound(data.shape[1]), 16)
    scalars = dict(n=n, cursor=cursor, cap=cap, accel=accel, toff=toff, prime=prime)
    _check(data, scalars, tables, out_capacity)
    if data.is_cuda:
        return _compress_cuda(data, n, cursor, cap, accel, toff, prime, tables, out_capacity)
    if data.device.type == "cpu":
        return compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity)
    raise ValueError(f"compress: unsupported device {data.device}")


def _compress_cuda(data, n, cursor, cap, accel, toff, prime, tables, out_capacity):
    lib = build.load()
    n_blocks, s = tables.shape
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8, device=data.device)
    out_len = torch.empty(n_blocks, dtype=torch.int32, device=data.device)
    status = torch.empty(n_blocks, dtype=torch.int32, device=data.device)
    table_out = torch.empty_like(tables)
    with torch.cuda.device(data.device):
        h = KERNEL.begin()
        rc = lib.lz4t_compress(
            data.data_ptr(), data.stride(0), n.data_ptr(), cursor.data_ptr(), cap.data_ptr(),
            accel.data_ptr(), toff.data_ptr(), prime.data_ptr(), tables.data_ptr(),
            table_out.data_ptr(), s, out.data_ptr(), out_capacity, out_len.data_ptr(),
            status.data_ptr(), n_blocks, stream_handle(),
        )
        KERNEL.end(h)
    build.check(rc, "compress")
    return out, out_len, status, table_out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _lcp(data: bytes, a: int, a_end: int, b: int, n: int) -> int:
    """Longest common prefix of data[a:a_end] and data[b:n]."""
    limit = min(a_end - a, n - b)
    m = 0
    while m + 16 <= limit and data[a + m : a + m + 16] == data[b + m : b + m + 16]:
        m += 16
    while m < limit and data[a + m] == data[b + m]:
        m += 1
    return m


def _lsic(out: bytearray, v: int) -> None:
    if v >= 0xF:
        v -= 0xF
        out.extend(b"\xff" * (v // 0xFF))
        out.append(v % 0xFF)


def _lsic_len(v: int) -> int:
    return 0 if v < 0xF else (v - 0xF) // 0xFF + 1


def parse_plain(data: bytes, init_cursor: int, cap: int, acceleration: int, toff: int,
                prime: bool, tab: list, u16: bool, out_capacity: int):
    """One block's greedy parse, the kernel's steps in Python.  ``tab`` (a
    list of slot values) is mutated in place.  Returns (bytes, status)."""
    n = len(data)
    hashes = (hash_all_u16(data) if u16 else hash_all_u32(data)).tolist()
    mask = 0xFFFF if u16 else 0xFFFFFFFF
    cap = (1 << 62) if cap < 0 else cap
    if prime and init_cursor >= 8:
        for p in range(0, init_cursor - 7, 3):
            tab[hashes[p]] = (p + toff) & mask
    out = bytearray()
    cursor = min(init_cursor, n)
    while cursor < n:
        literal_start = cursor
        step_counter = acceleration << SKIP_TRIGGER
        step = 1
        while True:
            if cursor + step > n - (LAST_LITERALS - 1):
                literal_len = n - literal_start
                group = 1 + _lsic_len(literal_len) + literal_len
                if len(out) + group > cap or len(out) + group > out_capacity:
                    return bytes(out), STATUS_INCOMPRESSIBLE
                out.append(min(literal_len, 0xF) << 4)
                _lsic(out, literal_len)
                out += data[literal_start:n]
                return bytes(out), STATUS_OK
            h = hashes[cursor]
            candidate = max(tab[h] - toff, 0)
            tab[h] = (cursor + toff) & mask
            if cursor != init_cursor and cursor - candidate <= 0xFFFF:
                matching = _lcp(data, cursor, n - MFLIMIT, candidate, n)
                if matching >= MINMATCH:
                    extra = matching - MINMATCH
                    offset = cursor - candidate
                    bt = 0
                    max_bt = cursor - literal_start
                    while (
                        bt < max_bt
                        and candidate - bt > 0
                        and data[cursor - bt - 1] == data[candidate - bt - 1]
                    ):
                        bt += 1
                    extra += bt
                    cursor += matching
                    tab[hashes[cursor - 2]] = (cursor - 2 + toff) & mask
                    break
            cursor += step
            if literal_start + 1 != cursor:
                step = step_counter >> SKIP_TRIGGER
                step_counter += 1
        literal_end = cursor - extra - MINMATCH
        literal_len = literal_end - literal_start
        group = 1 + _lsic_len(literal_len) + literal_len + 2 + _lsic_len(extra)
        if len(out) + group > cap or len(out) + group > out_capacity:
            return bytes(out), STATUS_INCOMPRESSIBLE
        out.append((min(literal_len, 0xF) << 4) | min(extra, 0xF))
        _lsic(out, literal_len)
        out += data[literal_start:literal_end]
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)
        _lsic(out, extra)
    return bytes(out), STATUS_OK


WARP = 32


def _probe(k: int, literal_start: int, acceleration: int):
    """(position, step) of probe ``k`` of a search that began at
    ``literal_start``, in closed form: advances go 1, 1, a, a, ... with the
    step assignment lagging one miss, so step(k) = a + ((k - 2) >> 6)."""
    if k < 2:
        return literal_start + k, 1
    m = k - 2
    q, r = m >> SKIP_TRIGGER, m & ((1 << SKIP_TRIGGER) - 1)
    return literal_start + 2 + m * acceleration + 32 * q * (q - 1) + q * r, acceleration + q


def _lcp_rounds(data: bytes, a: int, a_end: int, b: int, n: int, m: int = 0) -> int:
    """``_lcp`` as the warp takes it, from ``m`` bytes known to be equal: 4
    bytes a lane, 128 a round, the first lane that stops (a difference, or
    the limit inside its share) decides."""
    limit = min(a_end - a, n - b)
    while True:
        for lane in range(WARP):
            off = m + 4 * lane
            share = min(limit - off, 4)
            cnt = 0
            while cnt < share and data[a + off + cnt] == data[b + off + cnt]:
                cnt += 1
            if cnt < 4:
                return off + cnt
        m += 4 * WARP


def parse_batched_plain(data: bytes, init_cursor: int, cap: int, acceleration: int, toff: int,
                        prime: bool, tab: list, u16: bool, out_capacity: int):
    """One block's greedy parse by the CUDA kernel's steps (a model for the
    tests; ``parse_plain`` is the specification): batches of 32 probe
    positions from the skip schedule, every lane reading the table as it
    stood before the batch, in-batch collisions forwarded from the nearest
    lower lane through the slot type, the first hit or tail lane decides,
    and lanes up to it write the table.  Same arguments and results as
    ``parse_plain``."""
    n = len(data)
    hashes = (hash_all_u16(data) if u16 else hash_all_u32(data)).tolist()
    mask = 0xFFFF if u16 else 0xFFFFFFFF
    cap = (1 << 62) if cap < 0 else cap

    def write_group(lanes):
        """Lanes (hash, position) write their slots, the highest lane of a
        hash group last."""
        last = {}
        for h, p in lanes:
            last[h] = p
        for h, p in last.items():
            tab[h] = (p + toff) & mask

    if prime and init_cursor >= 8:
        for p0 in range(0, init_cursor - 7, 3 * WARP):
            write_group([(hashes[p], p)
                         for p in range(p0, min(p0 + 3 * WARP, init_cursor - 7), 3)])
    out = bytearray()
    cursor = min(init_cursor, n)
    while cursor < n:
        literal_start = cursor
        k0 = 0
        while True:
            lanes = []  # (hash, position) of the lanes that probe, in lane order
            hit = None
            tail = False
            for lane in range(WARP):
                p, step = _probe(k0 + lane, literal_start, acceleration)
                if p + step > n - (LAST_LITERALS - 1):
                    tail = True
                    break
                h = hashes[p]
                # the nearest lower lane with this hash, else the slot
                stored = next(((q + toff) & mask for g, q in reversed(lanes) if g == h), tab[h])
                candidate = max(stored - toff, 0)
                lanes.append((h, p))
                if p != init_cursor and p - candidate <= 0xFFFF and candidate + MINMATCH <= n:
                    # the lane holds 8 bytes of both sides: equal bytes among
                    # them, at most the match's limit
                    limit = min(n - MFLIMIT - p, n - candidate)
                    equal = 0
                    while equal < min(8, limit) and data[p + equal] == data[candidate + equal]:
                        equal += 1
                    if equal >= MINMATCH:
                        hit = (p, candidate, equal, equal == 8 and limit > 8)
                        break  # lanes above the first hit change nothing
            write_group(lanes)
            if hit or tail:
                break
            k0 += WARP
        if tail:
            literal_len = n - literal_start
            group = 1 + _lsic_len(literal_len) + literal_len
            if len(out) + group > cap or len(out) + group > out_capacity:
                return bytes(out), STATUS_INCOMPRESSIBLE
            out.append(min(literal_len, 0xF) << 4)
            _lsic(out, literal_len)
            out += data[literal_start:n]
            return bytes(out), STATUS_OK
        cursor, candidate, matching, open_ended = hit
        if open_ended:  # the match goes on past the probe's 8 bytes
            matching = _lcp_rounds(data, cursor, n - MFLIMIT, candidate, n, 8)
        extra = matching - MINMATCH
        offset = cursor - candidate
        max_bt = cursor - literal_start
        bt = 0
        while True:  # 32 bytes a round, the first lane that fails decides
            fails = [t for t in range(bt, bt + WARP)
                     if not (t < max_bt and candidate - t > 0
                             and data[cursor - t - 1] == data[candidate - t - 1])]
            if fails:
                bt = fails[0]
                break
            bt += WARP
        extra += bt
        cursor += matching
        tab[hashes[cursor - 2]] = (cursor - 2 + toff) & mask
        literal_end = cursor - extra - MINMATCH
        literal_len = literal_end - literal_start
        group = 1 + _lsic_len(literal_len) + literal_len + 2 + _lsic_len(extra)
        if len(out) + group > cap or len(out) + group > out_capacity:
            return bytes(out), STATUS_INCOMPRESSIBLE
        out.append((min(literal_len, 0xF) << 4) | min(extra, 0xF))
        _lsic(out, literal_len)
        out += data[literal_start:literal_end]
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)
        _lsic(out, extra)
    return bytes(out), STATUS_OK


def compress_batched_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity):
    """``compress_plain`` with ``parse_batched_plain`` as the parse: the
    kernel's design on CPU tensors, used by the tests only."""
    return compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity,
                          parse=parse_batched_plain)


def compress_plain(data, n, cursor, cap, accel, toff, prime, tables, out_capacity,
                   parse=parse_plain):
    """Plain version of the kernel on CPU tensors (same contract)."""
    n_blocks, s = tables.shape
    u16 = s == U16_SLOTS
    rows = data.numpy()
    n_l, cur_l, cap_l = n.tolist(), cursor.tolist(), cap.tolist()
    acc_l, toff_l, prime_l = accel.tolist(), toff.tolist(), prime.tolist()
    tab_in = tables.numpy().view(np.uint32)
    out = torch.zeros((n_blocks, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    out_len = torch.zeros(n_blocks, dtype=torch.int32)
    status = torch.zeros(n_blocks, dtype=torch.int32)
    table_out = torch.empty_like(tables)
    tab_out = table_out.numpy().view(np.uint32)
    for i in range(n_blocks):
        tab = tab_in[i].tolist()
        payload, st = parse(
            rows[i, : n_l[i]].tobytes(), cur_l[i], cap_l[i], acc_l[i],
            toff_l[i] & 0xFFFFFFFF, prime_l[i] != 0, tab, u16, out_capacity,
        )
        out_np[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        out_len[i] = len(payload)
        status[i] = st
        tab_out[i] = np.asarray(tab, dtype=np.uint32)
    return out, out_len, status, table_out


# ---------------------------------------------------------------------------
# host APIs
# ---------------------------------------------------------------------------


def compress_blocks(
    datas,
    cursors=None,
    tables=None,
    acceleration: int = 1,
    caps=None,
    prime_prefix=False,
    device=None,
):
    """Compress a batch of raw blocks (each entry may carry its own window
    prefix via ``cursors`` and a primed ``tables`` entry).

    Returns ``(outputs, tables)`` where ``outputs[i]`` is the compressed
    bytes or ``None`` if block ``i`` exceeded its cap (incompressible),
    and ``tables`` are the post-parse encoder tables, written back into
    the given table objects even on abort.
    """
    dev = resolve_device(device)
    n_blocks = len(datas)
    if n_blocks == 0:
        return [], []
    datas = [bytes(d) for d in datas]
    cursors = [0] * n_blocks if cursors is None else list(cursors)
    caps = [None] * n_blocks if caps is None else list(caps)
    if tables is None:
        tables = [U32Table() for _ in range(n_blocks)]
    width = round_up(max(max(len(d) for d in datas), 16), 16)
    tbl, offs = tables_from_jax(tables)
    params = np.array([[len(d) for d in datas], cursors,
                       [-1 if c is None else int(c) for c in caps],
                       [max(int(acceleration), 1)] * n_blocks, offs.numpy(),
                       [1 if prime_prefix else 0] * n_blocks], np.int64).astype(np.int32)
    (rows, _), params, tbl = hostpack.upload(dev, hostpack.Rows(datas, width=width), params, tbl)
    handle = hostpack.Handle(*compress_batch(rows, *params, tbl,
                                             round_up(compress_bound(width), 16)))
    out_len, status, table_np = handle.meta()
    stored = status == STATUS_INCOMPRESSIBLE
    table_np = table_np.view(np.uint32)
    rows = handle.collect(out_len, ~stored)
    outputs = []
    for i in range(n_blocks):
        tables[i].dict[:] = table_np[i].astype(tables[i].dict.dtype)
        outputs.append(None if stored[i] else bytes(rows[i]))
    return outputs, tables


def compress_block_cuda(
    data,
    cursor: int = 0,
    table=None,
    out=None,
    acceleration: int = 1,
    cap: int | None = None,
    device=None,
):
    """Single-block engine adapter; the same contract as the reference
    spec's ``compress_block``.  The CUDA kernel keeps no on-chip window of
    the block, so 4 MiB blocks take the same kernel."""
    data = bytes(data)
    if table is None:
        table = U16Table() if len(data) <= 0xFFFF else U32Table()
    if len(data) > table.payload_size_limit:
        raise BlockTooBig(
            f"input of {len(data)} bytes exceeds table limit {table.payload_size_limit}"
        )
    outputs, _ = compress_blocks(
        [data], [cursor], [table], acceleration=acceleration, caps=[cap], device=device
    )
    if outputs[0] is None:
        raise Incompressible()
    if out is not None:
        out.extend(outputs[0])
        return out
    return outputs[0]
