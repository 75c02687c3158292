"""The block work under the frame paths, for the whole-frame entry points
(``parallel.pipeline``) and the streaming API (``frame.compress``,
``frame.decompress``) alike.

A unit's blocks go to the card in one upload (``hostpack.upload``), the
kernel runs once over all of them, the lengths and statuses come back
right after it without blocking, then only the bytes needed, in one
staging buffer (``hostpack.Handle``) of which the host takes
``memoryview`` rows.  The units of a call (a mesh's ranges, a decode's
groups, the waves' chunks, the writer's batches) run through
``pipelined``: unit ``k + 1`` is launched before unit ``k`` is read, up to
``PIPELINE_DEPTH`` in flight and at most ``DECODE_BUDGET`` of rows on one
mesh entry.  On a mesh a frame's blocks are cut into one contiguous range
per entry (``ranges``); a linked range's upload also carries the 64 KiB of
input before it (the JAX package's ring halo).  ``decoder_for`` is the
frame paths' one decoder rule.
"""

from __future__ import annotations

from collections import Counter, deque

import numpy as np
import torch

from .. import hostpack
from ..frame.errors import DecodeError as FrameDecodeError
from ..kernels import pack
from ..kernels.compress import (KERNEL, SPLIT_KERNEL, compress_batch, compress_split,
                                multiprocessors, split_plan, split_seam)
from ..kernels.compress128 import MAX_B, compress128
from ..kernels.decode128 import MAX_BLOCK, decode128
from ..kernels.decodebig import decode_big
from ..kernels.decompress_v4 import decode_v4
from ..kernels.pack import budget_groups, check_decoded
from ..kernels.splice import splice_streams
from ..kernels.status import STATUS_INCOMPRESSIBLE
from ..runtime import count, round_up, span
from ..spec.block import WINDOW_SIZE, DecodeError
from ..spec.table import U32_SLOTS, U32Table, prime_u32_table
from ..utils.hashing import content_hash
from .mesh import shard_bounds

#: units (decode groups, mesh ranges, waves' groups) dispatched ahead of
#: the oldest one read, as ``lz4tpu``'s ``PIPELINE_DEPTH``; the units of a
#: mesh entry in flight together also stay under ``DECODE_BUDGET``
PIPELINE_DEPTH = 8


def ranges(n_items: int, devs):
    """``(lo, hi, device)`` of each mesh entry that gets items: an entry
    with none gets no launch."""
    return [(lo, hi, dev) for (lo, hi), dev in zip(shard_bounds(n_items, len(devs)), devs)
            if hi > lo]


def pipelined(units, dispatch, collect, depth=None) -> None:
    """Run ``units`` (``(entry, cost, work)``) in order with up to ``depth``
    (``PIPELINE_DEPTH``) dispatched before the oldest is collected, and at most
    ``DECODE_BUDGET`` of ``cost`` in flight on one mesh entry (a unit over
    it alone runs alone there).  ``dispatch(work)`` uploads and launches
    without waiting and returns a handle, or ``None`` when nothing stays in
    flight; ``collect(work, handle)`` waits for it.  Units are collected in
    the order given; when ``collect`` raises, the units still in flight
    are dropped unread."""
    depth = PIPELINE_DEPTH if depth is None else depth
    flight = deque()
    held = Counter()
    for entry, cost, work in units:
        while flight and (len(flight) >= depth
                          or (held[entry] and held[entry] + cost > pack.DECODE_BUDGET)):
            done_entry, done_cost, done, handle = flight.popleft()
            held[done_entry] -= done_cost
            collect(done, handle)
        handle = dispatch(work)
        if handle is not None:
            flight.append((entry, cost, work, handle))
            held[entry] += cost
    while flight:
        _, _, done, handle = flight.popleft()
        collect(done, handle)


def block_lens(n: int, block_size: int) -> np.ndarray:
    """Lengths of the frame's blocks; an empty input is one empty block."""
    n_blocks = max(-(-n // block_size), 1)
    lens = np.full(n_blocks, block_size, np.int32)
    lens[-1] = n - (n_blocks - 1) * block_size
    return lens


def _linked_rows(padded, n_blocks: int, block_size: int, full_first: bool):
    """Rows ``[the 64 KiB before block i | block i]`` of a linked range, cut
    on the device with one strided gather from ``padded`` = ``[the 64 KiB
    before the range | the range's blocks, padded whole]``.  A block whose
    window is not full (the frame's block 0 without a dictionary of at
    least 64 KiB) is laid out as an independent block, to be parsed at
    cursor 0 (``_linked_cursors``): an unprimed table's empty slots alias
    buffer position 0, which is only safe to parse from there."""
    w = WINDOW_SIZE
    rows = padded.as_strided((n_blocks, w + block_size), (block_size, 1)).contiguous()
    if not full_first:
        rows[0, :block_size] = padded[w : w + block_size].clone()  # rows may alias padded
        rows[0, block_size:] = 0
    return rows


def _linked_cursors(n_blocks: int, full_first: bool) -> np.ndarray:
    """Each linked row's cursor: 64 KiB, or 0 for a first block without a
    full window (``_linked_rows``)."""
    cursors = np.full(n_blocks, WINDOW_SIZE, np.int32)
    if not full_first:
        cursors[0] = 0
    return cursors


def scalar_route(lens, dictionary, parallel_linked, dev):
    """The ``compress.cu`` entry point of one launch over blocks of
    ``lens`` on ``dev``: (its launch counter's name, the seam spacing).
    Independent rows without a dictionary take the split parse
    (``compress_split``: each row cut at seams, a warp a segment) where the
    launch's shape gives it (``split_seam``); the rest take the one-warp
    kernel (``compress_batch``), seam ``None``."""
    seam = None
    if not parallel_linked and not dictionary:
        seam = split_seam(lens, multiprocessors(dev))
    return (KERNEL.name if seam is None else SPLIT_KERNEL.name), seam


def scalar_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, acceleration,
                  dev):
    """Blocks ``lo:hi`` of the frame through the scalar greedy compressor
    on the route ``scalar_route`` picks: their bytes in one upload, one
    launch on ``dev``, not waited for: a ``hostpack.Handle`` of the output
    rows, lengths and statuses."""
    w = WINDOW_SIZE
    d = len(dictionary or b"")
    n_blocks = hi - lo
    lens = lens[lo:hi]
    a = lo * block_size
    b = a + int(lens.sum())
    template = U32Table()
    _, seam = scalar_route(lens, dictionary, parallel_linked, dev)
    plan = None if seam is None else split_plan(lens, seam)
    if parallel_linked:
        # the range behind the 64 KiB of input before it (every block is at
        # least 64 KiB, so a range past the first has a full window); the
        # frame's first block is behind the dictionary's tail
        halo = min(a, w)
        head = dictionary[-w:] if lo == 0 and d >= w else b""
        full_first = lo > 0 or d >= w
        cursors = _linked_cursors(n_blocks, full_first)
    else:
        halo = 0
        head = dictionary or b""
        cursors = np.full(n_blocks, d, np.int32)
        if d:
            # every template position sits behind the cursor (buffer
            # coordinates equal dictionary coordinates), so the primed table is
            # shared.  Linked rows hold only the dictionary's tail, in other
            # coordinates: their tables are primed in the kernel instead
            prime_u32_table(template, dictionary)
    prime = (cursors > 0) if parallel_linked else np.zeros(n_blocks, bool)
    params = np.stack([lens + cursors, cursors, lens,  # output capped at input size
                       np.full(n_blocks, max(int(acceleration), 1)), np.zeros(n_blocks),
                       prime]).astype(np.int32)
    parts = [src[a - halo : b], params] + ([head] if head else [])
    if d and not parallel_linked:
        parts.append(template.dict.view(np.int32))
    if plan is not None:
        parts += [plan.warps, plan.row_first]
    content, params, *rest = hostpack.upload(dev, *parts)
    with span("lz4t.launch"):
        if parallel_linked:
            padded = torch.zeros(w + n_blocks * block_size, dtype=torch.uint8, device=dev)
            padded[w - halo : w + b - a].copy_(content)
            if head:
                padded[:w].copy_(rest[0])
            rows = _linked_rows(padded, n_blocks, block_size, full_first)
        else:
            # the range padded to whole blocks on the device
            flat = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
            flat[: b - a].copy_(content)
            rows = flat.view(n_blocks, block_size)
            if d:
                buf = torch.empty((n_blocks, d + block_size), dtype=torch.uint8, device=dev)
                buf[:, :d] = rest[0]
                buf[:, d:] = rows
                rows = buf
        width = round_up(block_size + 16, 16)
        if plan is not None:
            plan = plan._replace(warps=rest[0], row_first=rest[1])
            n, cap, accel = params[0], params[2], params[3]
            return hostpack.Handle(*compress_split(rows, n, cap, accel, seam, plan, width))
        if d and not parallel_linked:
            tables = rest[1].expand(n_blocks, U32_SLOTS).contiguous()
        else:
            tables = torch.zeros((n_blocks, U32_SLOTS), dtype=torch.int32, device=dev)
        out, out_len, status, _ = compress_batch(rows, *params, tables, width)
        return hostpack.Handle(out, out_len, status)


def scalar_collect(handle, lens):
    """The payloads of a ``scalar_launch`` over blocks of ``lens``: a
    ``memoryview`` a block, ``None`` where it is stored raw."""
    out_len, status, *split = handle.meta()
    if split:
        count(compress_seams=int(split[0][0].sum()),
              compress_seams_taken_over=int(split[0][1].sum()))
    return list(handle.collect(out_len, (status != STATUS_INCOMPRESSIBLE) & (lens > 0)))


def scalar_dispatch(src, block_size, dictionary, acceleration, dev):
    """An independent batch of whole blocks in one launch, not waited for
    (the batched writer's unit): (lens, handle) for ``scalar_collect``."""
    lens = block_lens(src.numel(), block_size)
    return lens, scalar_launch(src, 0, len(lens), lens, block_size, dictionary, False,
                               acceleration, dev)


def lane_launch(src, lo, hi, lens, block_size, dictionary, parallel_linked, chunk_windows,
                dev):
    """Output blocks ``lo:hi`` of the frame through the lane compressor,
    their bytes in one upload and one launch over all their chunks on
    ``dev``, not waited for: a ``hostpack.Handle`` of the output rows,
    lengths and tails.

    A chunk's row is cut from one flat source on the device by its base
    offset: the 64 KiB before the chunk, stopped at ``floor``, the first
    byte its block may refer to.  Linked frames: the source is ``[dictionary
    tail | input]`` (for a range past the first, the 64 KiB of input before
    it in the same upload) and the floor its start.  Independent frames:
    a window stays inside the chunk's own output block, whose source
    segment is ``[dictionary tail | block]``, so what lies before the
    segment is neither primed nor matched."""
    chunk = min(block_size, MAX_B)
    cpb = block_size // chunk  # chunks per output block
    n_blocks = hi - lo
    a = lo * block_size
    n = int(lens[lo:hi].sum())
    n_chunks = -(-n // chunk)
    idx = np.arange(n_chunks, dtype=np.int64)
    chunk_len = np.minimum(chunk, n - idx * chunk)
    tail = (dictionary or b"")[-WINDOW_SIZE:]
    d = len(tail)
    linked_range = parallel_linked and lo
    if linked_range:
        d = WINDOW_SIZE  # a range past the first starts 64 KiB before it
    if parallel_linked:
        start = d + idx * chunk
        floor = np.zeros(n_chunks, np.int64)
    elif d:
        segment = d + block_size
        floor = (idx // cpb) * segment
        start = floor + d + (idx % cpb) * chunk
    else:
        start = idx * chunk
        floor = (idx // cpb) * block_size
    # a dictionary is only addressable through a gapless window, so with one
    # the in-block windows stay whatever ``chunk_windows`` says
    if parallel_linked or d or (cpb > 1 and chunk_windows):
        base = np.maximum(start - WINDOW_SIZE, floor)
    else:
        base = start
    cur0 = (start - base).astype(np.int32)
    parts = [src[a - d : a + n] if linked_range else src[a : a + n], base,
             cur0 + chunk_len.astype(np.int32), cur0]
    data, base, ends, cur0, *rest = hostpack.upload(
        dev, *parts, *([tail] if d and not linked_range else []))
    with span("lz4t.launch"):
        if linked_range:
            flat = data
        elif parallel_linked:
            flat = torch.cat([rest[0], data]) if d else data
        elif d:
            buf = torch.zeros((n_blocks, segment), dtype=torch.uint8, device=dev)
            buf[:, :d] = rest[0]
            padded = torch.zeros(n_blocks * block_size, dtype=torch.uint8, device=dev)
            padded[:n] = data
            buf[:, d:] = padded.view(n_blocks, block_size)
            flat = buf.view(-1)
        else:
            flat = data
        return hostpack.Handle(*compress128(flat, base, ends, cur0))


def lane_collect(handle, lens, block_size):
    """The payloads of a ``lane_launch`` over output blocks of ``lens``:
    the chunk streams of each block spliced into one block, ``None`` where
    that is longer than the block."""
    cpb = block_size // min(block_size, MAX_B)
    out_len, tail_pos, tail_lit = handle.meta()
    tails = list(zip(tail_pos.tolist(), tail_lit.tolist()))
    streams = handle.collect(out_len)
    payloads = []
    for ob in range(len(lens)):
        c0, c1 = ob * cpb, min((ob + 1) * cpb, len(streams))
        payload = streams[c0] if c1 - c0 == 1 else splice_streams(
            [streams[c] for c in range(c0, c1)], tails[c0:c1])
        # the lane kernel has no output cap: a block that did not shrink
        # is stored raw, as the capped scalar parse would have it
        payloads.append(payload if len(payload) <= lens[ob] else None)
    return payloads


def decoder_for(block_maxsize: int, lane_kernel=None):
    """The decoder of a frame path's blocks under ``block_maxsize``:
    ``decode128`` up to 64 KiB unless ``lane_kernel`` is False; above it
    ``decode_big`` with ``lane_kernel=True``, else ``decode_v4``."""
    if block_maxsize <= MAX_BLOCK and lane_kernel is not False:
        return decode128
    return decode_big if lane_kernel else decode_v4


def decode_payloads(payloads, block_maxsize, dictionary, devs, lane_kernel=None):
    """The compressed payloads of an independent frame, decoded on each
    device of ``devs`` (a mesh's) that gets a range of them, one launch a
    group of blocks under ``DECODE_BUDGET`` (the budget is per device or
    mesh entry), group ``g + 1`` dispatched before group ``g`` is read
    (``pipelined``): the decoded blocks as ``memoryview`` rows in frame
    order.  Raises the first failing block's error in frame order (the
    frame layer's ``DecodeError`` of the decoder's kind, or
    ``BlockSizeOverflow`` for a block that decoded past ``block_maxsize``);
    groups in flight after it are dropped."""
    if not payloads:
        return []
    decoder = decoder_for(block_maxsize, lane_kernel)
    counted = lane_kernel is None and decoder is decode_v4  # big blocks, default route
    # every group gets the output capacity of one launch over all the
    # payloads, so that a hostile block stops where it would stop there
    width = round_up(max(map(len, payloads)), 16)
    out_capacity = round_up(block_maxsize + width, 16)
    shards = ranges(len(payloads), devs)
    groups = [[(lo + a, lo + b) for a, b in budget_groups(hi - lo, out_capacity + width)]
              for lo, hi, _ in shards]
    # group g of every range before group g + 1 of any, so that the ranges'
    # cards work side by side
    units = [(r, (b - a) * (out_capacity + width), (a, b, shards[r][2]))
             for g in range(max(map(len, groups)))
             for r, cuts in enumerate(groups) if g < len(cuts) for a, b in cuts[g:g + 1]]
    fetched = {}
    first_bad = None  # (block index, error): no group from there on need run

    def dispatch(work):
        a, b, dev = work
        if first_bad is not None and a >= first_bad[0]:
            return None
        if counted:
            count(big_blocks_v4=b - a)
        return launch_decode(decoder, payloads[a:b], block_maxsize, dictionary, out_capacity,
                             dev)

    def collect(work, handle):
        nonlocal first_bad
        a = work[0]
        if first_bad is not None and a >= first_bad[0]:
            return
        out_len, status = handle.meta()
        bad = check_decoded(status, out_len, block_maxsize)
        if bad is None:
            fetched[a] = handle.collect(out_len)
        elif first_bad is None or a + bad[0] < first_bad[0]:
            first_bad = (a + bad[0], bad[1])

    pipelined(units, dispatch, collect)
    if first_bad is not None:
        error = first_bad[1]
        raise FrameDecodeError(error.kind) if isinstance(error, DecodeError) else error
    return [row for a in sorted(fetched) for row in fetched[a]]


def launch_decode(decoder, payloads, block_maxsize, dictionary, out_capacity, dev):
    """One launch of ``decoder`` over ``payloads`` on ``dev`` (the payloads
    and the dictionary in one upload), not waited for: a
    ``hostpack.Handle`` of the output rows, lengths and statuses."""
    batch = hostpack.upload_batch(dev, payloads,
                                  [dictionary] * len(payloads) if dictionary else None)
    with span("lz4t.launch"):
        return hostpack.Handle(*decoder(*batch, block_maxsize, out_capacity))


def content_pieces(blocks, outputs) -> list:
    """The pieces of the frame's content in order: decoded ``outputs`` in
    the places of the compressed ``blocks`` (a scan's), stored payloads as
    they are."""
    outputs = iter(outputs)
    return [next(outputs) if compressed else payload for compressed, payload, _ in blocks]


def join_content(pieces, want_digest: bool, dev):
    """(The content joined from its ``pieces``, its content hash or
    ``None``): with ``want_digest`` the hash (``utils.hashing.content_hash``)
    starts before the join, so that it runs beside it; the caller checks
    it where its fault order says."""
    pieces = list(pieces)
    digest = content_hash(pieces, dev) if want_digest else None
    return b"".join(pieces), digest
