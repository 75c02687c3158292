"""Lane compressor: the CUDA kernel, its plain versions, and the host API.

Counterpart of ``lz4tpu/kernels/compress128.py``.  Each row is
``[window | block]`` bytes of one flat source tensor: the block (at most
``MAX_B`` = 32 KiB) is parsed from ``cur0``, behind a window of at most
64 KiB that matches may reach into.  One warp compresses one row
(``csrc/compress128.cu``): the row's packed table ``pos17 | tag15 << 17``
lives in shared memory, lane 0 searches, the warp copies the literals.
Any number of rows goes into one launch (the TPU's 128 is its vector
width, not part of the contract).

Three modes, each with its plain version here:

* default — ``PROBES`` positions a round, spaced by the skip schedule
  (``miss >> SKIP_TRIGGER``), every probed position inserted, the earliest
  tag hit verified by the forward compare (under 4 equal bytes is a false
  hit, resumed one byte on), forward extension to ``n - 5``, backward
  extension into the pending literals as far as the bytes match.  The
  output is valid LZ4 of about the greedy parse's size, not its bytes, and
  not ``lz4tpu``'s bytes either (its backward extension stops at its input
  pages);
* window — ``cur0 > 0``: the table is primed from the window as
  ``prime_tables_packed`` does (in the kernel, on the device), candidates
  may lie in the window, offsets are capped at 0xFFFF;
* STRICT — byte parity with the reference greedy parse (the scalar
  compressor, ``kernels/compress.py``) for rows without a window at
  ``hashlog`` 12: the 5-byte hash picks the bucket, an empty slot reads as
  position 0, the skip schedule, the unbounded backward extension and the
  ``cursor - 2`` re-insert are the reference's; the 15-bit tag only saves
  the byte compare where it cannot succeed.

Tensor contract of ``compress128`` (kernel and plain version alike):

* ``src`` (L,) uint8 — the flat source all rows are cut from;
* ``base`` (N,) int64 — row i is ``src[base[i] : base[i] + n[i]]``; every
  byte of a row is valid window or block (a caller cuts a window short by
  moving ``base`` up, not by masking);
* ``n`` (N,) int32 row lengths, ``cur0`` (N,) int32 parse starts;
* returns ``out`` (N, W) uint8 (zero past ``out_len``), ``out_len``, and
  ``tail_pos``/``tail_lit`` (N,) int32: where the stream's last token sits
  and how many literals follow it, which is what a splice needs
  (``kernels/splice.py``).  ``W`` is the worst case of the longest block,
  so there is no failure status.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build
from ..runtime import KernelStats, resolve_device, round_up, stream_handle
from ..spec.block import SKIP_TRIGGER, WINDOW_SIZE, compress_bound
from ..spec.table import U32_SLOTS
from ..state import LANE_SENTINEL
from .compress import _lcp, _lsic, parse_plain
from .splice import tail_split
from .status import STATUS_OK

KERNEL = KernelStats("compress128")
SOURCE = "lz4tpu_torch/csrc/compress128.cu"
REPLACES = "lz4tpu/kernels/compress128.py:156"

HASHLOG = 12  # table size: 1 << HASHLOG packed entries a row (16 KiB)
MIN_HASHLOG = 4
PROBES = 4  # positions probed a round
PROBE_SPAN = 24  # a round's probes stay within this many bytes of its first
MAX_B = 32 << 10  # block bytes a row may hold: 17-bit positions cover 96 KiB
HASH_MUL = 2654435761
SENTINEL = LANE_SENTINEL  # empty slot: a position no row reaches, tag 0
MISS0 = 1 << SKIP_TRIGGER

_POS_MASK = 0x1FFFF
_TAG_MASK = 0x7FFF


def _check(src, base, n, cur0, hashlog, strict):
    if src.dtype != torch.uint8 or src.dim() != 1 or not src.is_contiguous():
        raise ValueError("compress128: src must be a contiguous (L,) uint8 tensor")
    n_rows = n.shape[0] if n.dim() == 1 else -1
    for name, t, dtype in (("base", base, torch.int64), ("n", n, torch.int32),
                           ("cur0", cur0, torch.int32)):
        if t.dtype != dtype or t.shape != (n_rows,) or not t.is_contiguous():
            raise ValueError(f"compress128: {name} must be a contiguous (N,) {dtype} tensor")
        if t.device != src.device:
            raise ValueError(f"compress128: {name} is on {t.device}, src on {src.device}")
    if not MIN_HASHLOG <= int(hashlog) <= HASHLOG:
        raise ValueError(f"compress128: hashlog must be {MIN_HASHLOG}..{HASHLOG}")
    if strict and int(hashlog) != HASHLOG:
        raise ValueError("compress128: strict parity is defined for hashlog 12")
    if src.device.type not in ("cuda", "cpu"):
        raise ValueError(f"compress128: unsupported device {src.device}")
    if n_rows == 0:
        return 0
    # the rows' values, checked where they lie: the kernel reads src through
    # them and has no bounds checks of its own
    block = n - cur0
    bad = (
        (cur0 < 0) | (cur0 > WINDOW_SIZE) | (block < 0) | (block > MAX_B)
        | (base < 0) | (base + n > src.numel())
    )
    if strict:
        bad = bad | (cur0 != 0)
    n_bad, longest = torch.stack([bad.sum(), block.max().to(torch.int64)]).tolist()
    if n_bad:
        raise ValueError(
            f"compress128: {n_bad} rows out of range (row inside src, block <= {MAX_B}, "
            f"window <= {WINDOW_SIZE}" + (", no window in strict mode)" if strict else ")")
        )
    return int(longest)


def compress128(src, base, n, cur0, *, hashlog=HASHLOG, strict=False):
    """Compress a batch of rows; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring)."""
    longest = _check(src, base, n, cur0, hashlog, strict)
    out_capacity = round_up(compress_bound(longest), 16)
    if src.is_cuda:
        return _compress128_cuda(src, base, n, cur0, int(hashlog), bool(strict), out_capacity)
    return compress128_plain(src, base, n, cur0, int(hashlog), bool(strict), out_capacity)


def _compress128_cuda(src, base, n, cur0, hashlog, strict, out_capacity):
    lib = build.load()
    n_rows = n.shape[0]
    out = torch.zeros((n_rows, out_capacity), dtype=torch.uint8, device=src.device)
    out_len = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    tail_pos = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    tail_lit = torch.zeros(n_rows, dtype=torch.int32, device=src.device)
    if n_rows == 0:
        return out, out_len, tail_pos, tail_lit
    with torch.cuda.device(src.device):
        h = KERNEL.begin()
        rc = lib.lz4t_compress128(
            src.data_ptr(), base.data_ptr(), n.data_ptr(), cur0.data_ptr(), out.data_ptr(),
            out_capacity, out_len.data_ptr(), tail_pos.data_ptr(), tail_lit.data_ptr(),
            n_rows, hashlog, int(strict), stream_handle(),
        )
        KERNEL.end(h)
    build.check(rc, "compress128")
    return out, out_len, tail_pos, tail_lit


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _hash_words(row: bytes, hashlog: int):
    """Bucket and tag of the 4-byte word at every position that has one."""
    buf = np.frombuffer(row, np.uint8).astype(np.uint32)
    if len(buf) < 4:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    v = buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16) | (buf[3:] << 24)
    vm = v * np.uint32(HASH_MUL)  # wraps to 32 bits
    return vm >> np.uint32(32 - hashlog), (vm >> np.uint32(6)) & np.uint32(_TAG_MASK)


def prime_tables_packed(prefixes, hashlog: int = HASHLOG) -> torch.Tensor:
    """Window priming, the plain reference of what the kernel does on the
    device: every 3rd position of a window from 0 to ``len - 12`` as a
    packed ``pos17 | tag15 << 17`` entry in row coordinates, later
    positions overwriting earlier ones; windows under 16 bytes (and
    ``None``) leave the sentinel.  Returns (N, 1 << hashlog) int32."""
    tables = np.full((len(prefixes), 1 << hashlog), SENTINEL, np.uint32)
    for i, p in enumerate(prefixes):
        if p is None or len(p) < 16:
            continue
        bucket, tag = _hash_words(bytes(p), hashlog)
        pos = np.arange(0, len(p) - 12 + 1, 3, dtype=np.int64)
        # fancy assignment keeps the last of equal indices: insertion order
        tables[i, bucket[pos]] = pos.astype(np.uint32) | (tag[pos] << np.uint32(17))
    return torch.from_numpy(tables.view(np.int32))


def _emit(out: bytearray, row: bytes, anchor: int, mstart: int, offset: int, mlen: int) -> None:
    """One sequence: token, literal LSIC, literals, offset, match LSIC."""
    lit = mstart - anchor
    extra = mlen - 4
    out.append((min(lit, 0xF) << 4) | min(extra, 0xF))
    _lsic(out, lit)
    out += row[anchor:mstart]
    out.append(offset & 0xFF)
    out.append(offset >> 8)
    _lsic(out, extra)


def lane_parse_plain(row: bytes, cur0: int = 0, hashlog: int = HASHLOG):
    """One row's default/window-mode parse, the kernel's steps in Python.
    Returns (stream, tail_pos, tail_lit)."""
    n = len(row)
    bucket, tag = (a.tolist() for a in _hash_words(row, hashlog))
    tab = prime_tables_packed([row[:cur0]], hashlog)[0].numpy().view(np.uint32).tolist()
    out = bytearray()
    anchor = cur = cur0
    miss = MISS0
    while cur + 12 <= n:
        # one round: up to PROBES positions, all inserted, earliest hit wins
        q = cur
        nvalid = 0
        hit_q = hit_c = -1
        for j in range(PROBES):
            if j and (q + 12 > n or q - cur > PROBE_SPAN):
                break
            nvalid += 1
            h, t = bucket[q], tag[q]
            cand = tab[h]
            tab[h] = q | (t << 17)
            cpos = cand & _POS_MASK
            if hit_q < 0 and cpos < q and q - cpos <= 0xFFFF and cand >> 17 == t:
                hit_q, hit_c = q, cpos
            q += (miss + j) >> SKIP_TRIGGER
        if hit_q < 0:
            cur = q  # the first position not probed
            miss += nvalid
            continue
        mlen = _lcp(row, hit_q, n - 5, hit_c, n)
        if mlen < 4:  # a tag that lied, or a match too short
            cur = hit_q + 1
            miss += 1
            continue
        bt = 0
        max_bt = min(hit_q - anchor, hit_c)
        while bt < max_bt and row[hit_q - bt - 1] == row[hit_c - bt - 1]:
            bt += 1
        _emit(out, row, anchor, hit_q - bt, hit_q - hit_c, mlen + bt)
        anchor = cur = hit_q + mlen
        miss = MISS0
    tail_pos = len(out)
    lit = n - anchor
    out.append(min(lit, 0xF) << 4)
    _lsic(out, lit)
    out += row[anchor:]
    return bytes(out), tail_pos, lit


def strict_parse_plain(row: bytes):
    """One row's STRICT parse: the reference greedy parse with a fresh U32
    table at acceleration 1.  Returns (stream, tail_pos, tail_lit)."""
    stream, status = parse_plain(row, 0, -1, 1, 0, False, [0] * U32_SLOTS, False,
                                 compress_bound(len(row)))
    if status != STATUS_OK:
        raise RuntimeError("compress128: an uncapped parse aborted")
    if not stream:  # the reference writes nothing for no input
        return b"\x00", 0, 0
    return (stream, *tail_split(stream))


def compress128_plain(src, base, n, cur0, hashlog, strict, out_capacity):
    """Plain version of the kernel on CPU tensors (same contract)."""
    n_rows = n.shape[0]
    flat = src.numpy()
    out = torch.zeros((n_rows, out_capacity), dtype=torch.uint8)
    out_np = out.numpy()
    meta = np.zeros((3, n_rows), np.int32)
    for i, (b, ln, c0) in enumerate(zip(base.tolist(), n.tolist(), cur0.tolist())):
        row = flat[b : b + ln].tobytes()
        stream, tpos, tlit = strict_parse_plain(row) if strict else lane_parse_plain(row, c0, hashlog)
        out_np[i, : len(stream)] = np.frombuffer(stream, np.uint8)
        meta[:, i] = len(stream), tpos, tlit
    out_len, tail_pos, tail_lit = (torch.from_numpy(m.copy()) for m in meta)
    return out, out_len, tail_pos, tail_lit


# ---------------------------------------------------------------------------
# host API
# ---------------------------------------------------------------------------


def pack_lane_rows(blocks, prefixes=None):
    """Blocks (and their windows) -> the flat source and row scalars of
    ``compress128`` as numpy arrays: rows ``[prefix's last 64 KiB | block]``
    laid end to end."""
    n_rows = len(blocks)
    if prefixes is None:
        prefixes = [b""] * n_rows
    if len(prefixes) != n_rows:
        raise ValueError(f"{len(prefixes)} prefixes for {n_rows} blocks")
    rows = []
    cur0 = np.zeros(n_rows, np.int32)
    for i, (b, p) in enumerate(zip(blocks, prefixes)):
        b = bytes(b)
        if len(b) > MAX_B:
            raise ValueError(f"compress128: block {i} has {len(b)} bytes, over {MAX_B}")
        p = bytes(p or b"")[-WINDOW_SIZE:]
        cur0[i] = len(p)
        rows.append(p + b)
    n = np.array([len(r) for r in rows], np.int32)
    base = np.cumsum(n, dtype=np.int64) - n
    flat = np.frombuffer(b"".join(rows), np.uint8)
    return flat, base, n, cur0


def compress_blocks_128(blocks, *, hashlog=None, prefixes=None, strict=False, device=None):
    """Compress raw blocks (each at most 32 KiB) with the lane compressor,
    any number of them in one launch; returns a list of LZ4 block byte
    strings (``b"\\x00"`` for an empty block).

    ``prefixes`` (optional, one per block): window or dictionary bytes (the
    last 64 KiB count) that the block's matches may reach back into; a
    decoder needs the same bytes as its prefix.  ``strict=True`` gives the
    reference greedy parse's bytes (no prefixes, ``hashlog`` 12)."""
    dev = resolve_device(device)
    if len(blocks) == 0:
        return []
    if strict and prefixes is not None and any(prefixes):
        raise ValueError("compress128: strict parity covers blocks without a window")
    flat, base, n, cur0 = pack_lane_rows(blocks, prefixes)
    out, out_len, _, _ = compress128(
        torch.from_numpy(flat.copy()).to(dev),
        torch.from_numpy(base).to(dev),
        torch.from_numpy(n).to(dev),
        torch.from_numpy(cur0).to(dev),
        hashlog=HASHLOG if hashlog is None else hashlog,
        strict=strict,
    )
    out_len = out_len.cpu().numpy()
    rows = out[:, : int(out_len.max())].cpu().numpy()
    return [rows[i, : out_len[i]].tobytes() for i in range(len(blocks))]
