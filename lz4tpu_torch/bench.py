"""The port's bench: one JSON line of the card's decode, compress, frame and
transfer rates.

    python -m lz4tpu_torch.bench [MB] [--full] [--profile] [--device cpu]

Counterpart of the JAX package's ``bench.py``: the same corpora, sections
and keys (``tpu_`` reads ``cuda_``, ``tunnel_`` reads ``link_``).  The
headline is decode128.cu's rate over the Silesia stand-in's 64 KiB blocks
(``utils/silesia.py``, 211,938,580 B; blocks the greedy parse does not
shrink are stored, which no LZ4 decoder decodes, and are left out), in GB/s
per card, against the C library's single-core 4.5 GB/s.  ``MB`` (8 by
default: 128 blocks of 64 KiB) sizes the mixed corpus of the per-kernel
sections; ``--full`` adds decode_v4 over 16 and 64 blocks; ``--profile``
traces sections 3 to 6 with ``torch.profiler`` (``--trace`` names the
file).

Timing.  A kernel rate (``cuda_*``, ``silesia_*``) is the bytes decoded, or
the input bytes compressed, over the kernel's time from CUDA events around
its launches only (``runtime.KernelStats``): the rows are packed and on the
card before the clock starts, the first pass is checked byte for byte and
warms the kernel, then the best of ``reps`` passes counts (the spread goes
on an earlier line).  A pass is one launch a group of blocks under
``kernels.pack.DECODE_BUDGET``.  Frame, native and link rates are host wall
time of the entry point, ending in ``torch.cuda.synchronize()``, best of
``reps`` after a checked first call.  Rates are in MB/s (1e6 B/s).

Every section checks its bytes before it times: decoders every status 0
and every block equal to its input; compress.cu and the lane compressor's
STRICT mode the greedy parse's bytes; the lane compressor's default and
window mode streams that decode to their input; every frame round-tripped.
No section's failure is caught: it ends the run without a result line.

On the CPU (``--device cpu``) every section runs the kernels' plain
versions and every rate is host wall time; the keys that say ``cuda_`` on
the card say ``cpu_`` there.  Without a card and without ``--device cpu``
the bench raises.

The JAX package's TPU workarounds have no counterpart: the batch
scheduler's orders and round model, the "heavy" Silesia partition (every
64 KiB block fits decode128.cu), the lanes' in-kernel counts, STRICT's
cache clearing, and chained dispatches (the card's events time the kernel).

Environment: ``LZ4TPU_BENCH_SILESIA=0`` leaves out the Silesia section
(the headline is then decode128.cu's rate over the 64 MiB mixed corpus,
``cuda_decode_gbps_per_card``); ``LZ4TPU_BENCH_SIL_SCALE`` scales the
stand-in; ``LZ4TPU_BENCH_DBIG_MB_1M`` / ``_4M`` size the corpora of the
big-block decode (128 and 512 MiB).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import build, hostpack, native
from .frame.decompress import decompress_frame
from .kernels import compress as kc
from .kernels import compress128 as c128
from .kernels import decode128 as d128
from .kernels import decodebig as dbig
from .kernels import decompress_v3 as dv3
from .kernels import decompress_v4 as dv4
from .kernels.pack import budget_groups, pack_rows
from .kernels.status import OK, STATUS_OK
from .parallel.mesh import make_mesh
from .parallel.pipeline import compress_frame_parallel, decompress_frame_parallel
from .runtime import resolve_device, round_up
from .spec.block import WINDOW_SIZE, compress_bound
from .spec.table import U32Table
from .utils import silesia

BASELINE_DECODE_GBPS = 4.5  # C lz4 single-core decompress (BASELINE.md)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BLOCK = 1 << 16
KERNEL_MODULES = (kc, c128, d128, dv4, dbig, dv3)

#: sizes of the sections that the positional MB does not set, the JAX
#: bench's values; ``main(sizes=...)`` overrides them (the tests run small)
SIZES = dict(
    native_mb=8.0,  # cap of the host engine's input (its level(9) parse is slow)
    sched_mb=64.0,  # section 5: 1,024 blocks of 64 KiB
    sil_scale=1.0,  # section 6 (LZ4TPU_BENCH_SIL_SCALE)
    lane_blocks=128,  # sections 8 and 9: rows of 32 KiB
    dbig_mb_1m=128.0,  # section 10 (LZ4TPU_BENCH_DBIG_MB_1M)
    dbig_mb_4m=512.0,  # section 10 (LZ4TPU_BENCH_DBIG_MB_4M)
    compressbig_mb=32.0,  # section 11
    kernel_chunks=128,  # section 11: the 32 KiB chunks of one 4 MiB block
    link_mb=256,  # section 12 (8 MiB is launch-bound on the card)
    frame_mb=32.0,  # section 13
    reps=3,  # timed passes after the checked one
)

#: ``extra``'s keys of every run, ``cuda_`` where the card's kernels are
#: timed (``cpu_`` on the CPU); ``--full`` and ``--profile`` add theirs
KEYS = (
    "device", "launches", "corpus_mb", "block_ratio",
    "native_compress_mbps", "native_decompress_mbps", "native_compress_1t_mbps",
    "native_decompress_1t_mbps", "frame_ratio_4m", "hc_level9_ratio", "hc_level9_mbps",
    "cuda_decode_v4_mbps", "cuda_decode_v3_mbps", "cuda_decode128_mbps",
    "cuda_decode128_64m_mbps",
    "silesia_mb", "silesia_block_ratio", "silesia_coverage", "silesia_decode128_mbps",
    "cuda_compress_mbps", "cuda_compress128_mbps", "cuda_compress128_ratio",
    "cuda_compress128_strict_parity", "cuda_compress128_strict_mbps",
    "cuda_decodebig_1m_mbps", "cuda_decodebig_1m_blocks",
    "cuda_decodebig_4m_mbps", "cuda_decodebig_4m_blocks",
    "cuda_compressbig_mbps", "cuda_compressbig_ratio", "cuda_compressbig_fast_mbps",
    "cuda_compressbig_fast_ratio", "cuda_compressbig_kernel_mbps",
    "link_h2d_mbps", "link_d2h_mbps", "link_h2d_pinned_mbps", "link_d2h_pinned_mbps",
    "frame_compress_mbps", "frame_decode_mbps", "frame_parallel_ratio",
    "frame_compress_fast_mbps", "frame_compress_fast_ratio", "frame_linked_dict_ratio",
    "cuda_linked_dict_compress_mbps",
    "frame_decode_ceiling_mbps", "frame_decode_vs_ceiling",
    "frame_compress_ceiling_mbps", "frame_compress_vs_ceiling",
    "frame_compress_fast_ceiling_mbps", "frame_compress_fast_vs_ceiling",
    "cuda_compressbig_ceiling_mbps", "cuda_compressbig_vs_ceiling",
    "cuda_compressbig_fast_ceiling_mbps", "cuda_compressbig_fast_vs_ceiling",
)
FULL_KEYS = ("cuda_decode_v4_nb16_mbps", "cuda_decode_v4_nb64_mbps")
PROFILE_KEYS = ("profile_trace",)


def make_corpus(target_mb: float = 8.0) -> bytes:
    """The JAX bench's mixed corpus, byte for byte: three system binaries
    (those present) and 4 MiB of seeded synthetic spans (text-like motifs
    and random runs), repeated to ``target_mb`` MiB.  The binaries differ
    between machines: ``corpus_line`` prints a corpus's digest."""
    parts = []
    for p in [
        "/usr/bin/g++",
        "/usr/lib/x86_64-linux-gnu/libc.so.6",
        "/usr/lib/x86_64-linux-gnu/libstdc++.so.6",
    ]:
        try:
            with open(p, "rb") as f:
                parts.append(f.read())
        except OSError:
            pass
    rng = np.random.default_rng(0)
    motifs = [
        b"the quick brown fox jumps over the lazy dog. ",
        bytes(range(64)) * 4,
        b"<xml attr='value'><nested>text</nested></xml>\n",
    ]
    syn = bytearray()
    while len(syn) < 4 << 20:
        syn.extend(motifs[int(rng.integers(len(motifs)))] * int(rng.integers(1, 30)))
        syn.extend(rng.integers(0, 256, int(rng.integers(10, 300)), dtype=np.uint8).tobytes())
    parts.append(bytes(syn))
    data = b"".join(parts)
    n = int(target_mb * (1 << 20))
    return (data * (n // len(data) + 1))[:n]


def corpus_line(label: str, data: bytes) -> None:
    """A corpus's size and digest, so that two runs on one machine can be
    seen to read the same bytes."""
    digest = hashlib.sha256(data).hexdigest()[:16]
    print(f"  corpus {label}: {len(data):,d} B, sha256 {digest}", flush=True)


def split(data: bytes, size: int) -> list[bytes]:
    return [data[i : i + size] for i in range(0, len(data), size)]


def greedy(blocks) -> list[bytes]:
    """Each block through the native greedy parse (U32 table, acceleration
    1), on the host's threads: what compress.cu and STRICT must equal."""
    def one(b):
        return native.compress_block(b, 0, U32Table())

    if len(blocks) < 2:
        return [one(b) for b in blocks]
    with ThreadPoolExecutor(native.host_threads()) as pool:
        return list(pool.map(one, blocks))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Run:
    """One bench run: its device, timed passes, result line (``extra``) and
    the kernel launches it made."""

    def __init__(self, device=None, reps: int = SIZES["reps"]):
        self.dev = resolve_device(device)
        self.on_card = self.dev.type == "cuda"
        self.prefix = "cuda_" if self.on_card else "cpu_"
        self.reps = reps
        self.extra = {}
        self.launches = {m.KERNEL.name: 0 for m in KERNEL_MODULES}

    def key(self, name: str) -> str:
        """A kernel key: ``cuda_<name>`` on the card, ``cpu_<name>`` on the CPU."""
        return self.prefix + name

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def _pass(self, stats, calls, check=None):
        """(kernel ms, host wall ms) of one pass of ``calls`` (one launch
        each): the kernel's time is its CUDA events on the card, host wall
        on the CPU; the host wall ends in a synchronize.  Each call's
        result goes to ``check(i, result)`` (if given) and is then
        dropped, so one group's tensors are freed before the next's."""
        self.sync()
        if self.on_card:
            stats.reset(timing=True)
        before = stats.launches
        t0 = time.perf_counter()
        for i, call in enumerate(calls):
            result = call()
            if check is not None:
                check(i, result)
            del result
        self.sync()
        wall = (time.perf_counter() - t0) * 1e3
        if not self.on_card:
            return wall, wall
        ms = stats.elapsed_ms()
        launches = stats.launches - before
        stats.reset()
        if launches != len(calls):
            raise RuntimeError(f"{stats.name}: {launches} launches for {len(calls)} calls")
        self.launches[stats.name] += launches
        return ms, wall

    def kernel_rate(self, label, stats, calls, nbytes: int, check, moved) -> float:
        """Bytes a second of one pass of ``calls``, each launching
        ``stats``' kernel once: the first pass checked and warm, then the
        best of ``reps``.  Printed beside it: the host wall of a pass (its
        launches and the synchronize after them), a second clock, and the
        bound, the least time the card could take: ``moved`` bytes (each
        input read once, each output written once; a function, called
        after the check) over its memory rate."""
        self._pass(stats, calls, check)
        bound = moved() / HBM_BYTES_PER_S * 1e3
        times, walls = zip(*(self._pass(stats, calls) for _ in range(self.reps)))
        if not self.on_card:
            return self._report(label, nbytes, times, "host wall")
        return self._report(label, nbytes, times, "kernel",
                            f"; host wall of a pass, best {min(walls):.3f} ms; bound "
                            f"{bound:.4f} ms ({bound / min(times) * 100:.2f} % of it)")

    def wall_rate(self, label, fn, nbytes: int, check):
        """(bytes a second, first result) of ``fn`` by host wall time,
        ending in a synchronize: the first call's result goes to
        ``check``, then the best of ``reps`` calls."""
        self.sync()
        first = fn()
        self.sync()
        check(first)
        times = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            result = fn()
            self.sync()
            times.append((time.perf_counter() - t0) * 1e3)
            del result
        return self._report(label, nbytes, times, "host wall"), first

    @staticmethod
    def _report(label, nbytes, times, clock, note="") -> float:
        best = min(times)
        if best <= 0:
            raise RuntimeError(f"{label}: no time measured")
        spread = " ".join(f"{t:.3f}" for t in sorted(times))
        print(f"  {label}: {nbytes:,d} B, {clock} ms best {best:.3f} of [{spread}], "
              f"{nbytes / best / 1e3:.1f} MB/s{note}", flush=True)
        return nbytes / (best / 1e3)


def mbps(bytes_per_s: float) -> float:
    return round(bytes_per_s / 1e6, 1)


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------


def bench_corpus(run: Run, size_mb: float = 8.0):
    """Section 1: the mixed corpus, its 64 KiB blocks and their greedy
    parse (``corpus_mb``, ``block_ratio``)."""
    data = make_corpus(size_mb)
    corpus_line(f"mixed {size_mb:g} MiB", data)
    blocks = split(data, BLOCK)
    comp = greedy(blocks)
    run.extra["corpus_mb"] = round(len(data) / (1 << 20), 2)
    run.extra["block_ratio"] = round(sum(map(len, comp)) / len(data), 4)
    return data, blocks, comp


def bench_native(run: Run, data: bytes):
    """Section 2: the host engine on 4 MiB independent frames (threads(0)
    and threads(1), the 1-thread reader) and the level(9) HC parse; returns
    the threaded decompress rate."""
    from .frame.compress import CompressionSettings

    extra = run.extra
    s = CompressionSettings().engine("native")
    rate_c, frame = run.wall_rate("native compress", lambda: s.compress_bytes(data), len(data),
                                  lambda f: None)
    rate_d, _ = run.wall_rate(
        "native decompress", lambda: decompress_frame(frame, engine="native"), len(data),
        lambda out: _expect(out == data, "native: the frame does not round-trip"))
    extra["native_compress_mbps"] = mbps(rate_c)
    extra["native_decompress_mbps"] = mbps(rate_d)
    extra["frame_ratio_4m"] = round(len(frame) / len(data), 4)

    s1 = CompressionSettings().engine("native").threads(1)
    rate, _ = run.wall_rate(
        "native compress, threads(1)", lambda: s1.compress_bytes(data), len(data),
        lambda f: _expect(f == frame, "native: threads(1) wrote another frame"))
    extra["native_compress_1t_mbps"] = mbps(rate)
    old = os.environ.get("LZ4TPU_HOST_THREADS")
    os.environ["LZ4TPU_HOST_THREADS"] = "1"
    try:
        rate, _ = run.wall_rate(
            "native decompress, 1 thread", lambda: decompress_frame(frame, engine="native"),
            len(data), lambda out: _expect(out == data, "native: 1-thread read differs"))
    finally:
        if old is None:
            os.environ.pop("LZ4TPU_HOST_THREADS", None)
        else:
            os.environ["LZ4TPU_HOST_THREADS"] = old
    extra["native_decompress_1t_mbps"] = mbps(rate)

    s9 = CompressionSettings().engine("native").level(9)
    rate, f9 = run.wall_rate(
        "native level(9)", lambda: s9.compress_bytes(data), len(data),
        lambda f: _expect(decompress_frame(f, engine="native") == data,
                          "native: the level(9) frame does not round-trip"))
    extra["hc_level9_ratio"] = round(len(f9) / len(data), 4)
    extra["hc_level9_mbps"] = mbps(rate)
    return rate_d


def decode_rate(run: Run, label: str, decoder, stats, blocks, comp, limit: int) -> float:
    """Bytes a second of ``decoder`` over ``comp`` (no prefixes), one launch
    a group of blocks under ``DECODE_BUDGET``, the groups' rows packed and
    on the device before the clock starts."""
    width = round_up(max(map(len, comp)), 16)
    row = round_up(limit + width, 16) + width  # as kernels.decode128.decompress_batch counts
    groups = budget_groups(len(comp), row)
    packed = []
    for lo, hi in groups:
        packed.append(hostpack.upload_batch(run.dev, comp[lo:hi]))
    run.sync()

    def check(i, result):
        handle = hostpack.Handle(*result)
        lo, hi = groups[i]
        out_len, status = handle.meta()
        bad = np.flatnonzero(status != OK)
        _expect(not len(bad), f"{label}: block {lo + (bad[0] if len(bad) else 0)} "
                              f"status {status[bad[:1]]}")
        got = handle.collect(out_len)
        for j, b in enumerate(got):
            _expect(b == blocks[lo + j], f"{label}: block {lo + j} decodes to other bytes")

    calls = [lambda p=p: decoder(*p, limit) for p in packed]
    if len(groups) > 1:
        label += f" ({len(groups)} launches)"
    moved = sum(map(len, blocks)) + sum(map(len, comp))
    return run.kernel_rate(label, stats, calls, sum(map(len, blocks)), check, lambda: moved)


def bench_decode(run: Run, blocks, comp, name: str, n_blocks=None) -> float:
    """Sections 3 and 15: decode_v4 or decode_v3 over the corpus's 64 KiB
    blocks (``n_blocks`` of them, repeated as needed)."""
    mod = {"v4": dv4, "v3": dv3}[name]
    decoder = getattr(mod, f"decode_{name}")
    if n_blocks is not None:
        blocks = (blocks * (n_blocks // len(blocks) + 1))[:n_blocks]
        comp = (comp * (n_blocks // len(comp) + 1))[:n_blocks]
    bps = decode_rate(run, f"decode_{name}, {len(blocks)} x 64 KiB", decoder, mod.KERNEL,
                      blocks, comp, BLOCK)
    suffix = "" if n_blocks is None else f"_nb{n_blocks}"
    run.extra[run.key(f"decode_{name}{suffix}_mbps")] = mbps(bps)
    return bps


def bench_decode128(run: Run, blocks, comp, n_blocks: int = 128) -> float:
    """Section 4: decode128 over the corpus's first 128 blocks."""
    bps = decode_rate(run, f"decode128, {len(blocks[:n_blocks])} x 64 KiB", d128.decode128,
                      d128.KERNEL, blocks[:n_blocks], comp[:n_blocks], BLOCK)
    run.extra[run.key("decode128_mbps")] = mbps(bps)
    return bps


def bench_decode128_64m(run: Run, size_mb: float = 64.0) -> float:
    """Section 5: decode128 over the 64 MiB mixed corpus (1,024 blocks),
    one launch a ``DECODE_BUDGET`` group, in frame order."""
    data = make_corpus(size_mb)
    corpus_line(f"mixed {size_mb:g} MiB", data)
    blocks = split(data, BLOCK)
    bps = decode_rate(run, f"decode128, {len(blocks)} x 64 KiB", d128.decode128, d128.KERNEL,
                      blocks, greedy(blocks), BLOCK)
    run.extra[run.key("decode128_64m_mbps")] = mbps(bps)
    return bps


def silesia_blocks(scale: float):
    """The Silesia stand-in's 64 KiB blocks, their greedy parse, and which
    blocks are stored (the parse does not shrink them)."""
    members = silesia.corpus(scale, cache=False)
    data = b"".join(members.values())
    corpus_line(f"Silesia stand-in at scale {scale:g}", data)
    blocks = split(data, BLOCK)
    comp = greedy(blocks)
    lens = np.array([len(b) for b in blocks])
    stored = np.array([len(c) for c in comp]) >= lens
    return blocks, comp, stored


def bench_silesia_decode(run: Run, scale: float = 1.0) -> float:
    """Section 6, the headline: decode128 over the stand-in's blocks that
    are not stored, packed once, one launch a ``DECODE_BUDGET`` group."""
    blocks, comp, stored = silesia_blocks(scale)
    lens = np.array([len(b) for b in blocks])
    clens = np.array([len(c) for c in comp])
    tot = int(lens.sum())
    extra = run.extra
    extra["silesia_mb"] = round(tot / (1 << 20), 1)
    extra["silesia_block_ratio"] = round(
        int(clens[~stored].sum() + lens[stored].sum()) / tot, 4)
    extra["silesia_coverage"] = (f"decoded {lens[~stored].sum() / tot * 100:.1f}% / "
                                 f"stored {lens[stored].sum() / tot * 100:.1f}%")
    keep = np.flatnonzero(~stored)
    bps = decode_rate(run, f"Silesia: decode128, {len(keep)} of {len(blocks)} blocks",
                      d128.decode128, d128.KERNEL, [blocks[i] for i in keep],
                      [comp[i] for i in keep], BLOCK)
    extra["silesia_decode128_mbps"] = mbps(bps)
    return bps


def bench_compress(run: Run, blocks, comp, n_blocks: int = 128) -> float:
    """Section 7: compress.cu over 64 KiB rows with fresh U32 tables, its
    output equal to the greedy parse's bytes."""
    blocks, comp = blocks[:n_blocks], comp[:n_blocks]
    n = len(blocks)
    rows, lens = pack_rows(blocks, run.dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=run.dev)
    caps = torch.full((n,), -1, dtype=torch.int32, device=run.dev)
    accel = torch.ones(n, dtype=torch.int32, device=run.dev)
    tables = torch.zeros((n, 4096), dtype=torch.int32, device=run.dev)
    out_capacity = round_up(compress_bound(rows.shape[1]), 16)
    run.sync()

    def check(_, result):
        handle = hostpack.Handle(*result[:3])
        out_len, status = handle.meta()
        _expect(bool((status == STATUS_OK).all()), "compress: a row did not compress")
        got = handle.collect(out_len)
        for i, c in enumerate(got):
            _expect(c == comp[i], f"compress: row {i} differs from the greedy parse")

    def call():
        return kc.compress_batch(rows, lens, zeros, caps, accel, zeros, zeros, tables,
                                 out_capacity)

    nbytes = sum(map(len, blocks))
    moved = nbytes + sum(map(len, comp)) + 2 * tables.numel() * 4  # rows, streams, tables
    bps = run.kernel_rate(f"compress, {n} x 64 KiB", kc.KERNEL, [call], nbytes, check,
                          lambda: moved)
    run.extra[run.key("compress_mbps")] = mbps(bps)
    return bps


def lane_rate(run: Run, label, blocks, prefixes, strict: bool, check) -> float:
    """Bytes a second of compress128 over rows ``[prefix | block]``;
    ``check(i, result)`` returns the streams' total size."""
    flat, base, n, cur0 = c128.pack_lane_rows(blocks, prefixes)
    args = [torch.from_numpy(a.copy()).to(run.dev) for a in (flat, base, n, cur0)]
    run.sync()
    call = lambda: c128.compress128(*args, strict=strict)  # noqa: E731
    nbytes = sum(map(len, blocks))  # the windows are bytes of the rows before
    out_bytes = []
    return run.kernel_rate(label, c128.KERNEL, [call], nbytes,
                           lambda i, result: out_bytes.append(check(i, result)),
                           lambda: nbytes + out_bytes[0])


def lane_streams(result):
    handle = hostpack.Handle(*result[:2])
    return handle.collect(handle.meta()[0])


def bench_compress128(run: Run, data: bytes, n_blocks: int = 128) -> float:
    """Section 8: the lane compressor (default mode) over 32 KiB rows;
    every stream must decode to its row.  Also its ratio."""
    blocks = split(data, c128.MAX_B)[:n_blocks]
    sizes = []

    def check(_, result):
        streams = lane_streams(result)
        for i, (b, s) in enumerate(zip(blocks, streams)):
            _expect(native.decompress_block(s, output_limit=len(b)) == b,
                    f"compress128: row {i} does not decode to its input")
        sizes.append(sum(map(len, streams)))
        return sizes[-1]

    bps = lane_rate(run, f"compress128, {len(blocks)} x 32 KiB", blocks, None, False, check)
    run.extra[run.key("compress128_mbps")] = mbps(bps)
    run.extra[run.key("compress128_ratio")] = round(sizes[0] / sum(map(len, blocks)), 4)
    return bps


def bench_compress128_strict(run: Run, data: bytes, n_blocks: int = 128) -> float:
    """Section 9: the lane compressor's STRICT mode over 32 KiB rows, each
    stream equal to the greedy parse's bytes."""
    blocks = split(data, c128.MAX_B)[:n_blocks]
    refs = greedy(blocks)
    parity = []

    def check(_, result):
        streams = lane_streams(result)
        parity.append(sum(a == b for a, b in zip(streams, refs)))
        _expect(parity[0] == len(blocks),
                f"compress128 STRICT: {parity[0]} of {len(blocks)} rows equal the greedy parse")
        return sum(map(len, streams))

    bps = lane_rate(run, f"compress128 STRICT, {len(blocks)} x 32 KiB", blocks, None, True, check)
    run.extra[run.key("compress128_strict_parity")] = f"{parity[0]}/{len(blocks)} (32 KiB blocks)"
    run.extra[run.key("compress128_strict_mbps")] = mbps(bps)
    return bps


def bench_decodebig(run: Run, name: str, block_size: int, size_mb: float) -> float:
    """Section 10: decode_big over the mixed corpus's first 128 full blocks
    of ``block_size``, one launch a ``DECODE_BUDGET`` group."""
    data = make_corpus(size_mb)
    corpus_line(f"mixed {size_mb:g} MiB", data)
    bigs = [b for b in split(data, block_size) if len(b) == block_size][:128]
    del data
    if not bigs:
        raise ValueError(f"decode_big {name}: {size_mb} MiB holds no block of {block_size} B")
    bps = decode_rate(run, f"decode_big, {len(bigs)} x {block_size >> 20} MiB", dbig.decode_big,
                      dbig.KERNEL, bigs, greedy(bigs), block_size)
    run.extra[run.key(f"decodebig_{name}_mbps")] = mbps(bps)
    run.extra[run.key(f"decodebig_{name}_blocks")] = len(bigs)
    return bps


def bench_compressbig(run: Run, size_mb: float = 32.0, block_size: int = 4 << 20,
                      kernel_chunks: int = 128) -> None:
    """Section 11: 4 MiB blocks through the lane compressor, spliced from
    32 KiB chunks behind in-block windows, and without the windows
    (``chunk_windows=False``); then the kernel alone on block 0's first
    ``kernel_chunks`` chunks, each behind the 64 KiB of the block before it."""
    data = make_corpus(size_mb)
    corpus_line(f"mixed {size_mb:g} MiB", data)
    mesh = make_mesh(devices=[run.dev])
    extra = run.extra

    def round_trips(frame):
        _expect(decompress_frame(frame, engine="native") == data,
                "compressbig: the frame does not round-trip")

    for suffix, windows in (("", True), ("_fast", False)):
        rate, frame = run.wall_rate(
            f"compress_frame_parallel, lane, {block_size >> 20} MiB blocks"
            + ("" if windows else ", chunk_windows=False"),
            lambda w=windows: compress_frame_parallel(data, block_size=block_size, mesh=mesh,
                                                      lane_kernel=True, chunk_windows=w),
            len(data), round_trips)
        extra[run.key(f"compressbig{suffix}_mbps")] = mbps(rate)
        extra[run.key(f"compressbig{suffix}_ratio")] = round(len(frame) / len(data), 4)

    chunk = c128.MAX_B
    n_chunks = min(kernel_chunks, block_size // chunk, -(-len(data) // chunk))
    chunks = [data[j * chunk : (j + 1) * chunk] for j in range(n_chunks)]
    windows = [data[max(j * chunk - WINDOW_SIZE, 0) : j * chunk] for j in range(n_chunks)]

    def check(_, result):
        streams = lane_streams(result)
        for j, s in enumerate(streams):
            _expect(native.decompress_block(s, windows[j], output_limit=len(chunks[j]))
                    == chunks[j], f"compressbig: chunk {j} does not decode behind its window")
        return sum(map(len, streams))

    bps = lane_rate(run, f"compress128, block 0's {n_chunks} chunks behind their windows",
                    chunks, windows, False, check)
    extra[run.key("compressbig_kernel_mbps")] = mbps(bps)


def bench_link(run: Run, mb: int = 256) -> None:
    """Section 12: host-device copies of ``mb`` MiB of random bytes, 1 MiB
    rows, through the frame paths' transport (``hostpack``): H2D as
    ``hostpack.upload`` sends rows (one staging span, one copy, the rows
    gathered on the device), D2H as a launch's rows are collected
    (``hostpack.fetch``: compacted on the device into one staging span);
    beside them, both ways through pinned host memory in one copy.  On the
    CPU there is no link: each copy is a host copy."""
    row = 1 << 20
    n = mb * row
    host = torch.from_numpy(np.random.default_rng(7).integers(0, 256, n, dtype=np.uint8))
    want = host.numpy().tobytes()
    items = [memoryview(want)[i * row : (i + 1) * row] for i in range(mb)]
    lens = np.full(mb, row)

    def h2d(src, pinned=False):
        return src.to(run.dev, non_blocking=pinned) if run.on_card else src.clone()

    def same(t):
        _expect(torch.equal(t.cpu().view(-1) if run.on_card else t.view(-1), host),
                "link: the copy differs")

    extra = run.extra
    rate, (rows, _) = run.wall_rate("H2D hostpack.upload",
                                    lambda: hostpack.upload(run.dev, hostpack.Rows(items))[0], n,
                                    lambda got: same(got[0]))
    extra["link_h2d_mbps"] = mbps(rate)
    rate, _ = run.wall_rate("D2H hostpack.fetch", lambda: hostpack.fetch(rows, lens).wait(), n,
                            lambda got: _expect(b"".join(got) == want,
                                                "link: hostpack.fetch differs"))
    extra["link_d2h_mbps"] = mbps(rate)
    dev = rows.view(-1)

    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=run.on_card)
    pinned.copy_(host)
    rate, _ = run.wall_rate("H2D pinned", lambda: h2d(pinned, True), n, same)
    extra["link_h2d_pinned_mbps"] = mbps(rate)
    back = torch.empty(n, dtype=torch.uint8, pin_memory=run.on_card)

    def d2h_pinned():
        back.copy_(dev, non_blocking=run.on_card)
        return back

    rate, _ = run.wall_rate("D2H pinned", d2h_pinned, n, same)
    extra["link_d2h_pinned_mbps"] = mbps(rate)


def bench_frame_parallel(run: Run, data: bytes, size_mb: float = 32.0) -> None:
    """Section 13: frames of 64 KiB blocks on a mesh of one device:
    ``size_mb`` MiB compressed (compress.cu) and decoded (decode128), the
    lane frame without windows, and the JAX bench's config #3 (the main
    corpus linked behind a 64 KiB dictionary, lane compressor)."""
    mesh = make_mesh(devices=[run.dev])
    fdata = make_corpus(size_mb)
    corpus_line(f"mixed {size_mb:g} MiB", fdata)
    extra = run.extra
    rate, frame = run.wall_rate(
        "compress_frame_parallel, 64 KiB blocks",
        lambda: compress_frame_parallel(fdata, block_size=BLOCK, mesh=mesh), len(fdata),
        lambda f: None)
    extra["frame_compress_mbps"] = mbps(rate)
    rate, _ = run.wall_rate(
        "decompress_frame_parallel, 64 KiB blocks",
        lambda: decompress_frame_parallel(frame, mesh=mesh), len(fdata),
        lambda out: _expect(out == fdata, "frame: the frame does not round-trip"))
    extra["frame_decode_mbps"] = mbps(rate)
    extra["frame_parallel_ratio"] = round(len(frame) / len(fdata), 4)

    rate, ff = run.wall_rate(
        "compress_frame_parallel, lane, 64 KiB blocks, chunk_windows=False",
        lambda: compress_frame_parallel(fdata, block_size=BLOCK, mesh=mesh, lane_kernel=True,
                                        chunk_windows=False), len(fdata),
        lambda f: _expect(decompress_frame(f, engine="native") == fdata,
                          "frame: the lane frame does not round-trip"))
    extra["frame_compress_fast_mbps"] = mbps(rate)
    extra["frame_compress_fast_ratio"] = round(len(ff) / len(fdata), 4)
    del fdata, frame, ff

    dictionary = data[:WINDOW_SIZE]
    rate, fl = run.wall_rate(
        "compress_frame_parallel, lane, linked, 64 KiB dictionary",
        lambda: compress_frame_parallel(data, block_size=BLOCK, mesh=mesh, parallel_linked=True,
                                        dictionary=dictionary, lane_kernel=True), len(data),
        lambda f: _expect(decompress_frame(f, dictionary=dictionary, engine="native") == data,
                          "frame: the linked dictionary frame does not round-trip"))
    extra["frame_linked_dict_ratio"] = round(len(fl) / len(data), 4)
    extra[run.key("linked_dict_compress_mbps")] = mbps(rate)


def frame_ceilings(extra: dict, prefix: str = "cuda_") -> None:
    """Section 14: composed transport ceilings of the frame paths from the
    same run's pageable link rates: a frame decode moves its compressed
    bytes up (ratio over H2D) and its content down (over D2H), one after
    the other on one stream, so its ceiling is ``1 / (r/h2d + 1/d2h)``;
    mirrored for compress.  ``*_vs_ceiling`` is the share reached."""
    h2d, d2h = extra.get("link_h2d_mbps"), extra.get("link_d2h_mbps")
    if not h2d or not d2h:
        return
    for name, rate_key, ratio_key, up_r in (
        ("frame_decode", "frame_decode_mbps", "frame_parallel_ratio", True),
        ("frame_compress", "frame_compress_mbps", "frame_parallel_ratio", False),
        ("frame_compress_fast", "frame_compress_fast_mbps", "frame_compress_fast_ratio", False),
        (f"{prefix}compressbig", f"{prefix}compressbig_mbps", f"{prefix}compressbig_ratio",
         False),
        (f"{prefix}compressbig_fast", f"{prefix}compressbig_fast_mbps",
         f"{prefix}compressbig_fast_ratio", False),
    ):
        r = extra.get(ratio_key)
        rate = extra.get(rate_key)
        if r is None or rate is None:
            continue
        if up_r:  # decode: comp up, raw down
            ceil = 1.0 / (r / h2d + 1.0 / d2h)
        else:  # compress: raw up, comp down
            ceil = 1.0 / (1.0 / h2d + r / d2h)
        extra[f"{name}_ceiling_mbps"] = round(ceil, 1)
        extra[f"{name}_vs_ceiling"] = round(rate / ceil, 3)


@contextlib.contextmanager
def profiled(run: Run, path):
    """A ``torch.profiler`` trace of the block, written to ``path``; the
    ten ops of most device (or host) time go on earlier lines."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.on_card else [])
    with profile(activities=acts) as prof:
        yield
    run.sync()
    prof.export_chrome_trace(str(path))
    sort = "device_time_total" if run.on_card else "cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=10), flush=True)
    run.extra["profile_trace"] = str(path)


def main(argv=None, sizes=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lz4tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("mb", nargs="?", type=float, default=8.0,
                    help="MiB of the mixed corpus of the per-kernel sections (8: 128 blocks)")
    ap.add_argument("--full", action="store_true", help="add decode_v4 over 16 and 64 blocks")
    ap.add_argument("--profile", action="store_true",
                    help="trace sections 3-6 with torch.profiler")
    ap.add_argument("--trace", default=str(build.BUILD_DIR / "bench_trace.json"),
                    help="where --profile writes its chrome trace")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    sizes = {**SIZES, **(sizes or {})}
    for name, key in (("1m", "dbig_mb_1m"), ("4m", "dbig_mb_4m")):
        sizes[key] = float(os.environ.get(f"LZ4TPU_BENCH_DBIG_MB_{name.upper()}", sizes[key]))
    sizes["sil_scale"] = float(os.environ.get("LZ4TPU_BENCH_SIL_SCALE", sizes["sil_scale"]))
    with_silesia = os.environ.get("LZ4TPU_BENCH_SILESIA", "1") == "1"

    run = Run(args.device, reps=int(sizes["reps"]))
    if run.on_card:
        device = card_line()
        build.load()  # outside every section's time
    else:
        device = "cpu (plain versions; rates are host wall time)"
    print(f"device: {device}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    run.extra["device"] = device
    k = run.key

    marks = []

    def section(title):
        now = time.perf_counter()
        if marks:
            run.sync()
            peak = ""
            if run.on_card:
                mib = torch.cuda.max_memory_allocated(run.dev) / 2**20
                peak = f", peak device memory {mib:,.0f} MiB"
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(run.dev)
            print(f"-- {marks[-1][0]}: {now - marks[-1][1]:.1f} s{peak}", flush=True)
        marks.append((title, now))
        if title:
            print(f"== {title}", flush=True)

    section("1: the mixed corpus")
    data, blocks, comp = bench_corpus(run, args.mb)
    section("2: the host engine")
    bench_native(run, data[: int(sizes["native_mb"] * (1 << 20))])
    prof = profiled(run, args.trace) if args.profile else contextlib.nullcontext()
    with prof:
        section("3: decode_v4 and decode_v3")
        bench_decode(run, blocks, comp, "v4")
        bench_decode(run, blocks, comp, "v3")
        section("4: decode128")
        bench_decode128(run, blocks, comp)
        section("5: decode128 over the 64 MiB corpus")
        mixed64 = bench_decode128_64m(run, sizes["sched_mb"])
        silesia_bps = None
        if with_silesia:
            section("6: decode128 over the Silesia stand-in (the headline)")
            silesia_bps = bench_silesia_decode(run, sizes["sil_scale"])
    section("7: compress")
    bench_compress(run, blocks, comp)
    section("8: compress128")
    bench_compress128(run, data, sizes["lane_blocks"])
    section("9: compress128 STRICT")
    bench_compress128_strict(run, data, sizes["lane_blocks"])
    section("10: decode_big")
    bench_decodebig(run, "1m", 1 << 20, sizes["dbig_mb_1m"])
    bench_decodebig(run, "4m", 4 << 20, sizes["dbig_mb_4m"])
    section("11: the lane compressor on 4 MiB blocks")
    bench_compressbig(run, sizes["compressbig_mb"], kernel_chunks=sizes["kernel_chunks"])
    section("12: the host-device link")
    bench_link(run, int(sizes["link_mb"]))
    section("13: frames on a mesh of one device")
    bench_frame_parallel(run, data, sizes["frame_mb"])
    frame_ceilings(run.extra, run.prefix)
    if args.full:
        section("15: decode_v4 over 16 and 64 blocks")
        for nb in (16, 64):
            bench_decode(run, blocks, comp, "v4", n_blocks=nb)
    section("")
    run.extra["launches"] = dict(run.launches)

    if silesia_bps is not None:
        value = silesia_bps / 1e9
        metric = "cuda_decode_gbps_per_card_silesia" if run.on_card else "cpu_decode_gbps_silesia"
    else:
        value = mixed64 / 1e9
        metric = "cuda_decode_gbps_per_card" if run.on_card else "cpu_decode_gbps"
    value = round(value, 4)  # vs_baseline is the printed value's, not a second rounding's
    print(f"{metric} from {k('decode128')}: {value:.4f} GB/s on {device}")
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "GB/s",
        "vs_baseline": round(value / BASELINE_DECODE_GBPS, 4),
        "extra": run.extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
