"""The linked waves of ``decompress_frames_parallel``: wave ``w`` decodes
block ``w`` of every linked frame in one launch a group of frames under
``DECODE_BUDGET``, each block behind its own frame's carry-over window.

The windows are right-aligned 64 KiB rows on the device: each wave's rows
(its decoded blocks, then its stored ones) slide into the next wave's rows
in one launch a wave group (``kernels/window.py``), so at most two waves'
windows are held.  The waves run in chunks of whole wave groups under
``DECODE_BUDGET``: one upload of a chunk's blocks, one output tensor its
groups decode into (``into=``), and one ``hostpack.Handle`` back.

Spans: ``lz4t.plan`` (the pieces and chunks), ``lz4t.wave`` (a wave
group's launch and slide) and ``lz4t.push`` (a slide); ``stats()`` counts
``linked_frames``, ``waves``, ``wave_launches`` and ``window_pushes``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import hostpack
from ..frame.errors import BlockSizeOverflow
from ..frame.errors import DecodeError as FrameDecodeError
from ..kernels import pack
from ..kernels.pack import budget_groups
from ..kernels.status import OK, STATUS_TO_KIND
from ..kernels.window import push_windows
from ..runtime import count, round_up, span, traced
from ..spec.block import WINDOW_SIZE
from .blocks import decoder_for, pipelined

#: device bytes that a wave's row takes beside its output and compressed
#: block, past its own window: the next wave's window row and the plain
#: version's int64 byte positions and copies
PUSH_BYTES = 28 * WINDOW_SIZE


@traced("lz4t.push")
def _push_windows(old, old_len, data, lens, dest, new, new_len):
    """Slide the carry-over windows of a wave's rows ``old`` (their
    lengths ``old_len``) over their new bytes ``data[k, :lens[k]]`` into
    the next wave's rows ``new[dest[k]]`` (``dest[k]`` -1: the frame has no
    next block): one launch of ``kernels.window.push_windows``."""
    count(window_pushes=1)
    push_windows(old, old_len, data, lens, dest, new, new_len)


@dataclass
class _Piece:
    """Rows ``a:b`` of wave ``w`` in the wave's order (its compressed
    blocks, then its stored ones): a budget group of compressed blocks,
    decoded in one launch (``decoder`` set), or the wave's stored blocks,
    which only slide their windows.  ``dest`` is each row's row in wave
    ``w + 1`` (-1: none).  A row takes ``cap`` bytes of output (0 for a
    stored block) and ``rest`` bytes besides; ``k`` is the place of the
    decoded rows in their chunk's output."""

    w: int
    a: int
    b: int
    payloads: list
    dest: np.ndarray
    cap: int
    rest: int
    limit: int = 0
    decoder: object = None
    maxsizes: np.ndarray = None
    last: bool = False  # the wave's last launch: raises its size overflow
    closes: bool = False  # the wave's last piece: its windows are let go after it
    k: int = 0


def _wave_plan(linked):
    """The pieces of ``linked``'s waves, in wave order, and the rows of
    each wave (the frames' slots in ``linked``)."""
    chains = [blocks for _, _, blocks, _ in linked]
    order = []
    for w in range(max(map(len, chains), default=0)):
        todo = [s for s, c in enumerate(chains) if w < len(c) and c[w][0]]
        stored = [s for s, c in enumerate(chains) if w < len(c) and not c[w][0]]
        order.append((todo, stored))
    rows = [todo + stored for todo, stored in order]
    pieces = []
    for w, (todo, stored) in enumerate(order):
        at = dict(zip(rows[w + 1], range(len(rows[w + 1])))) if w + 1 < len(rows) else {}
        dest = np.array([at.get(slot, -1) for slot in rows[w]], np.int32)
        if todo:
            count(waves=1)
            maxsizes = np.array([linked[slot][1].block_maxsize for slot in todo])
            limit = int(maxsizes.max())
            payloads = [chains[slot][w][1] for slot in todo]
            width = round_up(max(map(len, payloads)), 16)
            # a launch's rows: output, compressed block, its window, the slide's
            cap, rest = round_up(limit + width, 16), width + WINDOW_SIZE + PUSH_BYTES
            cuts = budget_groups(len(todo), cap + rest)
            for g, (a, b) in enumerate(cuts):
                pieces.append(_Piece(w, a, b, payloads[a:b], dest[a:b], cap, rest, limit,
                                     decoder_for(limit, lane_kernel=True), maxsizes[a:b],
                                     g == len(cuts) - 1))
        n = len(todo)
        for a, b in budget_groups(len(stored), WINDOW_SIZE + PUSH_BYTES):
            pieces.append(_Piece(w, n + a, n + b, [chains[slot][w][1] for slot in stored[a:b]],
                                 dest[n + a : n + b], 0, WINDOW_SIZE + PUSH_BYTES))
        pieces[-1].closes = True
    return pieces, rows


def _chunks(pieces):
    """Consecutive pieces in chunks under ``DECODE_BUDGET`` (a piece over
    it alone): each chunk one upload of its blocks, one output tensor of
    its decoded rows at the widest ``cap`` among them, and one fetch.
    Sets each decoding piece's ``k``; yields ``(cost, pieces, decoded
    rows, cap)``."""
    chunk, rows, cap, rest = [], 0, 0, 0
    for p in pieces + [None]:
        n = 0 if p is None else p.b - p.a
        out = 0 if p is None or p.decoder is None else n
        if chunk and (p is None or (rows + out) * max(cap, p.cap) + rest + n * p.rest
                      > pack.DECODE_BUDGET):
            yield rows * cap + rest, chunk, rows, cap
            chunk, rows, cap, rest = [], 0, 0, 0
        if p is not None:
            chunk.append(p)
            p.k = rows
            rows += out
            cap = max(cap, p.cap)
            rest += n * p.rest


def decode_waves(linked, dictionaries, dev):
    """Decode ``linked`` (``(frame index, reader, scanned blocks, expected
    checksum)`` a linked frame; ``dictionaries`` by frame index) in waves
    on ``dev``, raising ``decompress_frames_parallel``'s errors: an
    iterator of each frame's content pieces (a decoded row, or a stored
    block's payload), made as the caller takes them."""
    count(linked_frames=len(linked))
    with span("lz4t.plan"):
        pieces, rows = _wave_plan(linked)
        units = [(0, cost, work) for cost, *work in _chunks(pieces)]
    # per frame, in block order: the payload of a stored block, or (piece,
    # row of its chunk) of a decoded one
    parts = [[] for _ in linked]
    for p in pieces:
        for k, slot in enumerate(rows[p.w][p.a : p.b]):
            parts[slot].append((id(p), p.k + k) if p.decoder is not None else p.payloads[k])
    # the windows of each wave's rows, right-aligned, and their lengths: the
    # dictionaries' tails before the first wave; wave w + 1's are written by
    # wave w's slides, so that one wave's are read while the next's are made
    heads = [dictionaries[linked[slot][0]] for slot in rows[0]] if rows else []
    if any(heads):
        (first, first_len), = hostpack.upload(dev, hostpack.Rows(heads, align_right=True))
        if first.shape[1] < WINDOW_SIZE:
            first = torch.nn.functional.pad(first, (WINDOW_SIZE - first.shape[1], 0))
    else:
        first = torch.zeros((len(heads), WINDOW_SIZE), dtype=torch.uint8, device=dev)
        first_len = torch.zeros(len(heads), dtype=torch.int32, device=dev)
    windows = {0: (first, first_len)}
    decoded = {}
    overflow = False

    def dispatch(work):
        chunk, n_rows, cap = work
        *blocks, dest = hostpack.upload(
            dev, *(hostpack.Rows(p.payloads, whole=True) for p in chunk),
            np.concatenate([p.dest for p in chunk]))
        # the chunk's decoded rows, and their lengths and statuses
        out = torch.empty((n_rows, cap), dtype=torch.uint8, device=dev)
        meta = torch.empty((2, n_rows), dtype=torch.int32, device=dev)
        d = 0
        for p, (comp, comp_len) in zip(chunk, blocks):
            n = p.b - p.a
            if p.w + 1 < len(rows) and p.w + 1 not in windows:
                m = len(rows[p.w + 1])
                windows[p.w + 1] = (torch.empty((m, WINDOW_SIZE), dtype=torch.uint8, device=dev),
                                    torch.empty(m, dtype=torch.int32, device=dev))
            old, old_len = (t[p.a : p.b] for t in windows[p.w])
            slide = (dest[d : d + n], *windows.get(p.w + 1, ())) if (p.dest >= 0).any() else None
            d += n
            if p.decoder is None:
                if slide:
                    _push_windows(old, old_len, comp, comp_len, *slide)
            else:
                with span("lz4t.wave"):
                    count(wave_launches=1)
                    with span("lz4t.launch"):
                        data, data_len, _ = p.decoder(
                            comp, comp_len, old, old_len, p.limit, cap,
                            into=(out[p.k : p.k + n], *meta[:, p.k : p.k + n]))
                    if slide:
                        _push_windows(old, old_len, data, data_len, *slide)
            if p.closes:
                del windows[p.w]
        return hostpack.Handle(out, meta) if n_rows else None

    def collect(work, handle):
        nonlocal overflow
        chunk = work[0]
        (lens, status), = handle.meta()
        for p in chunk:
            if p.decoder is None:
                continue
            st, got = status[p.k : p.k + p.b - p.a], lens[p.k : p.k + p.b - p.a]
            # a decode error anywhere in the wave wins over a size overflow
            if (st != OK).any():
                raise FrameDecodeError(STATUS_TO_KIND[int(st[st != OK][0])])
            overflow |= bool((got > p.maxsizes).any())
            if p.last and overflow:
                raise BlockSizeOverflow("a block decompressed to more data than allowed")
        fetched = handle.collect(lens)
        for p in chunk:
            decoded[id(p)] = fetched

    pipelined(units, dispatch, collect)
    return ([decoded[p[0]][p[1]] if isinstance(p, tuple) else p for p in ps] for ps in parts)
