#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py                 # full run: needs one CUDA card
    python3 chip_smoke.py --scale 0.05    # smaller corpus (main path)
    python3 chip_smoke.py --profile       # + host and device profile of each path

Phases, in order; any mismatch or exception exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the kernel build (nvcc, one process per source);
2. every CUDA kernel against its plain PyTorch version on the same inputs
   (the plain version runs on a CPU copy): the lane compressor in its three
   modes (default: 128 chunks of 32 KiB and the edge payloads; window: rows
   with a full, a short, an unprimed and no window, a dictionary-seeded head
   chunk, the 384 chunks of three 4 MiB blocks with their in-block
   windows, and the 32 rows of a linked 1 MiB segment, timed as one launch
   of phase 5c; STRICT: also against the greedy compressor's kernel), the
   greedy compressor (U16/U32
   tables, acceleration 1 and 8, dictionary-primed tables with a cursor,
   in-kernel priming, caps that trigger Incompressible, the 1 MiB and
   4 MiB rows of big-block frames and the ``[64 KiB window | block]`` rows
   of linked ones, both timed alone; the edges of its warp-wide parse:
   stale tables behind a table offset on rows that collide inside a batch,
   megabyte literal runs before far copies, tiny rows, rows off the
   16-byte grid, one row under every cap), its split parse (a row cut at
   seams, a warp a segment, the proven pieces stitched) against its
   one-warp kernel on every member's 4 MiB blocks, a launch a member, and
   timed beside it on one 4 MiB row of xml, the largest member and one
   random 4 MiB row (every seam taken over: within 1.25 times the one-warp
   kernel's time, or the script fails), with the seams and takeovers it
   counted, and the four decoders,
   decode128, decompress_v4, decode_big and decompress_v3 (64 KiB
   prefixes, hostile blocks, seeded mutations of valid blocks, hand-made
   streams at the edges of a 32-sequence batch, literal-heavy streams into
   64 KiB many times decode128's window, streams on which decompress_v4's
   speculative walks never fall into step (its serial finish), one 64 KiB
   block behind a 64 KiB prefix, timed in turns on decode128, decode_big
   and decompress_v4 as one wave of phase 5d, and a member's 782 blocks
   timed in turns on decompress_v3 and decode128; for the last three also
   blocks of 256 KiB, 1 MiB and 4 MiB without a prefix, with a 64 KiB
   prefix and with a prefix too short for their offsets, and streams with
   length runs and long sequences all along; the largest block alone timed
   in turns on decode_big and decompress_v4), and the slide of linked
   frames' windows between waves (``kernels/window.py``).  Bytes, lengths,
   statuses and tables must be equal: a byte codec has no tolerance;
3. the 64 KiB independent-block path at full size: each Silesia stand-in
   member (scale 1.0: 211,938,580 bytes) through ``compress_frame_parallel(block_size=65536,
   content_checksum=True)`` and ``decompress_frame_parallel`` on the card,
   plus a dictionary frame and a 4 MiB-block frame (decoded by
   decompress_v4, the default route for big blocks, and, with
   ``lane_kernel=True``, by decode_big);
4. the big-block and linked-frame path at full size, over the same
   corpus: (a) each member as an independent frame of 4 MiB blocks
   (decompress_v4); (b) each member cut
   into 1 MiB segments, each a linked frame of 64 KiB blocks from
   ``compress_frame_parallel(parallel_linked=True)``, all decoded by one
   ``decompress_frames_parallel`` call (waves on decode128); (c) each
   member as one linked frame of 4 MiB blocks, decoded by one such call
   (waves on decode_big); (d) one member's 64 KiB blocks through
   ``decompress_blocks_v3``;
5. the lane compressor's path at full size, over the same corpus, through
   ``compress_frame_parallel(lane_kernel=True)``: (a) each member as an
   independent frame of true 4 MiB blocks, each block 128 chunks spliced
   (decompress_v4); (b) each member at 64 KiB independent blocks (decode128);
   (c) the 1 MiB segments as ``parallel_linked`` lane frames, all decoded by
   one ``decompress_frames_parallel`` call, and no larger than the same
   segments as independent lane frames; (d) a dictionary frame, independent
   at 4 MiB blocks and linked at 64 KiB blocks.  Beside each, the same frame
   geometry through the scalar compressor (phases 3, 4a, 4b).  Then the size
   contract: over the corpus cut into 32 KiB blocks, the lane compressor's
   total must be no larger than the greedy compressor's;
6. the reference's own entry points, over the same corpus: (a) every
   member through ``CompressionSettings()`` (4 MiB independent blocks,
   content checksum: one compress.cu launch a member) and
   ``decompress_frame`` (one decompress_v4 launch), in turns with the
   per-block path (a callable engine of ``compress_block_cuda``, a
   ``decode_block`` loop); both frames equal to phase 4a's; (b) one member
   at 64 KiB blocks with block checksums and a 64 KiB dictionary
   (decode128 batched, decompress_v4 per block), and
   ``into_read().read(n)`` in odd-sized pieces; (c) one member as a linked
   frame of 4 MiB blocks through the per-block writer and reader; (d) the
   CLI (``python3 -m lz4tpu_torch.cli.dolz4`` / ``delz4``) as subprocesses
   on one member: engines ``cuda`` and ``cuda-parallel`` (frames equal to
   6a's and 4a's), ``cuda-parallel --lane-kernel``, and ``--level 9`` on a
   256 KiB slice;
7. the device mesh and the resumable runner, over the same corpus: (a)
   phase 3's geometry through ``compress_frame_parallel(mesh=...)`` and
   ``decompress_frame_parallel(mesh=...)`` on a mesh of every card and on
   a mesh of four entries of ``cuda:0`` (and, with more cards, on each
   count of them), decoded once more on decompress_v4; (b) phase 4b's
   linked segments on the four-entry mesh, decoded by one
   ``decompress_frames_parallel(mesh=...)`` call; (c) phase 5a's lane
   frames on the four-entry mesh, each launch taking whole 4 MiB blocks;
   (d) ``run_sharded_compress`` over the corpus as one file in 16 MiB
   shards (13), resumed after three shard files are deleted,
   ``run_sharded_decompress``, and two processes on ``cuda:0`` that meet
   through ``torch.distributed`` (gloo) and claim alternate shards.
   Frames and archives must be byte-equal to the phases they mirror and to
   each other, and a call must launch each kernel once on every mesh entry
   that gets work.  On one card this measures the sharding's cost, not
   scaling;
8. the host engine (``engine("native")``, the C++ codec built by ``c++``),
   over the same corpus: (a) ``CompressionSettings().level(9)`` at 4 MiB
   independent blocks over dickens on ``"cuda"`` (compress.cu's greedy
   payloads, the native HC parse) and on ``"native"``, frames equal, no
   larger than 4a's and read back on ``"cuda"`` (decompress_v4), and the
   native HC parse beside ``spec.hc`` on a 256 KiB head; (b) the default
   writer and reader on ``"native"`` with ``threads(1)`` and
   ``threads(0)``, frames equal to 6a's; (c) 6c's linked frame on
   ``"native"``, equal to 6c's; (d) ``dolz4``/``delz4 --engine native``
   round trips, compared with ``cmp``.  Host rates, printed with the
   host's CPU and the card's name and power limit beside the same run's
   device rates; the native paths must launch no kernel;
9. bounded-memory decode (the F1 frames): (a) 25,000 one-byte blocks under
   a 4 MiB block maxsize (over 100 GB of output rows as one launch) and
   (b) 200,000 under 64 KiB, each through ``read_all`` on ``"cuda"``,
   ``decompress_frame_parallel`` (and ``lane_kernel=False``) and
   ``read_all`` on ``"native"``, both in one ``decompress_frames_parallel``
   call (the default route takes (a)'s groups to decompress_v4); (c)
   25,000 one-block linked frames of 4 MiB maxsize in one
   ``decompress_frames_parallel`` call (one wave).  Each call prints its
   peak device memory, launches (its groups) and wall time, and fails if
   the peak passes ``DECODE_BUDGET`` + the packed compressed rows + the
   content + 256 MiB (+ 64 KiB a linked frame; + decompress_v4's scratch);
10. the bench and the entry points of `entry.py`: (a) ``python -m
   lz4tpu_torch.bench`` as a subprocess at its defaults (every kernel timed
   on its own inputs after a checked pass, the Silesia stand-in's headline;
   at ``--scale`` under 1 its Silesia and big-block corpora are scaled
   down), whose JSON line must hold every key, STRICT parity 128/128 and a
   launch of each of the six kernels; (b) ``lz4tpu_torch.entry.entry()``'s
   step (decode128 over its example batch) against its payloads and its
   plain version; (c) ``dryrun_multichip`` on a mesh of every card and on
   four entries of ``cuda:0``;
11. the transport (``lz4tpu_torch/hostpack.py``: pinned staging, the copy
   stream, units dispatched ``PIPELINE_DEPTH`` ahead): (a) a fetched result
   held while later fetches and decodes take staging keeps its bytes; (b) a
   frame of 64 KiB blocks decoded on one device and on three entries of
   ``cuda:0``, linked frames in waves and the batched writer in 2 MiB
   batches, at the budget and with it shrunk to groups of about 24 blocks,
   twice each, equal to the content or to the one-launch frame; (c) the
   device trace (torch.profiler) of phase 3's mozilla decompress and 5a's
   mozilla compress: each memcpy kind with its largest copy and the busy
   share, failing on a pageable copy over 8 KiB; (d) the launches of phases
   3-8 and 9 beside those counted before the transport (``PERF.md``: B3,
   R2), which at full scale must be equal.

In phases 3 to 10 outputs must be byte-equal to the inputs, and every
kernel of a path must have been launched on it: the launch counts are set
to 0 before each path and read after it.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SEGMENT = 1 << 20  # phase 4 (b): a log segment or page group
RUNNER_SHARD = 16 << 20  # phase 7 (d): the runner's shard, 13 of them at full scale
# phase 9: blocks of the F1 frames at 4 MiB and 64 KiB maxsize, and linked frames
F1_BLOCKS = {"4 MiB": 25_000, "64 KiB": 200_000}
F1_LINKED = 25_000
# phase 11: the launches of phases 3-8 and of phase 9 at full scale, as the
# runs before the transport (PERF.md: B3 for 3-8, R2 for 9) counted them,
# with the default route's groups of big blocks on decode_v4 in place of
# decode_big, and the 26 launches of independent 4 MiB-block frames written
# without a dictionary (phases 3, 4a, 6a, 8a) on compress.cu's split parse
# in place of its one-warp kernel (the same launches, another kernel); 6d's
# one 256 KiB row stays on the one-warp kernel (split_seam's SPLIT_REACH)
LAUNCHES_3_8 = {"compress": 1526, "compress_split": 26, "decode_big": 74, "compress128": 272,
                "decode128": 477, "decode_v4": 784, "decode_v3": 1}
LAUNCHES_9 = {"decode_big": 143, "decode128": 39, "decode_v4": 409}
PAGEABLE_MAX = 8 << 10  # phase 11: the largest pageable copy a frame path may make


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median kernel-call time over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def in_turns(names, calls, rounds: int = 2):
    """Median ``cuda_ms`` of each call, timed in turns (the order and its
    reverse, ``rounds`` times), so that each is first as often."""
    turns = {name: [] for name in names}
    for order in (tuple(names), tuple(names)[::-1]) * rounds:
        for name in order:
            turns[name].append(cuda_ms(calls[name]))
    return {name: sorted(t)[len(t) // 2] for name, t in turns.items()}


def cut_blocks(data: bytes, size: int, k: int):
    """``k`` blocks of ``size`` bytes spread evenly over ``data``."""
    span = max(len(data) - size, 0)
    return [data[(span * j) // max(k - 1, 1):][:size] for j in range(k)]


def same(name, got, want, labels=("out", "out_len", "status", "tables")) -> int:
    """Hold kernel tensors against plain ones exactly; returns the largest
    absolute difference (0)."""
    import torch

    for label, g, w in zip(labels, got, want):
        g = g.cpu()
        if g.shape != w.shape:
            fail(f"{name}: {label} shape {tuple(g.shape)} != {tuple(w.shape)}")
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item() if g.numel() else 0
        if diff != 0:
            bad = (g != w).reshape(g.shape[0], -1).any(dim=1).nonzero().flatten().tolist()
            fail(f"{name}: {label} differs from the plain version in blocks {bad[:10]}")
    return 0


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from lz4tpu_torch import build

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)")
    from lz4tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    print(f"native engine build (c++) and load: {time.perf_counter() - t0:.2f} s")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line or "stack frame" in line
                    or line.startswith("==")):
                print("  " + line.strip())
    return smi


def check_compress(members):
    """The compressor against its plain version; returns the report."""
    import numpy as np
    import torch

    from lz4tpu_torch.kernels import compress as kc
    from lz4tpu_torch.spec.block import compress_bound
    from lz4tpu_torch.spec.table import U16_SLOTS, U32_SLOTS, U32Table, prime_u32_table

    per = 4
    names = list(members)

    def batch(datas, cursors, caps, accel, tables, prime, toffs=None, width=0):
        n = len(datas)
        width = max(width, max(len(d) for d in datas))
        arr = np.zeros((n, width), np.uint8)
        for i, d in enumerate(datas):
            arr[i, : len(d)] = np.frombuffer(d, np.uint8)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32)

        return (
            torch.from_numpy(arr), i32([len(d) for d in datas]), i32(cursors), i32(caps),
            i32([accel] * n), i32(toffs or [0] * n), i32(prime), torch.from_numpy(tables),
        )

    # A: the main path's shape — 64 KiB blocks, U32 tables, cap = block size
    # (two seeded random blocks make sure the cap is hit)
    rnd = random.Random(0xCAFE)
    blocks = [b for m in names for b in cut_blocks(members[m], 65536, per)]
    blocks += [rnd.randbytes(65536) for _ in range(2)]
    n = len(blocks)
    cases = {
        "u32_main": batch(blocks, [0] * n, [len(b) for b in blocks], 1,
                          np.zeros((n, U32_SLOTS), np.int32), [0] * n),
    }
    # B: U16 tables (blocks <= 0xFFFF), acceleration 8, no cap
    small = [b[:60000] for b in blocks[: max(n // 6, 2)]]
    cases["u16_accel8"] = batch(small, [0] * len(small), [-1] * len(small), 8,
                                np.zeros((len(small), U16_SLOTS), np.int32), [0] * len(small))
    # C: dictionary — host-primed table + cursor, and in-kernel priming
    dic = members[names[0]][:32768]
    t = U32Table()
    prime_u32_table(t, dic)
    dblocks = [dic + b[:32768] for b in blocks[: max(n // 6, 2)]]
    k = len(dblocks)
    tabs = np.zeros((k, U32_SLOTS), np.int32)
    tabs[: k // 2] = t.dict.view(np.int32)
    cases["dict_cursor"] = batch(dblocks, [len(dic)] * k, [-1] * k, 1, tabs,
                                 [0] * (k // 2) + [1] * (k - k // 2))
    # D: the dictionary frame's rows — 64 KiB dictionary + 64 KiB block at
    # cursor 65536, so candidates in the dictionary fall outside the 0xFFFF
    # window and must be rejected
    dic = members[names[0]][-65536:]
    t = U32Table()
    prime_u32_table(t, dic)
    wblocks = [dic + b for b in blocks[: 8]]
    k = len(wblocks)
    tabs = np.zeros((k, U32_SLOTS), np.int32)
    tabs[: k // 2] = t.dict.view(np.int32)
    cases["dict64k_window"] = batch(wblocks, [len(dic)] * k, [65536] * k, 1, tabs,
                                    [0] * (k // 2) + [1] * (k - k // 2))
    # E: the 4 MiB-block frame's rows — 1 MiB and 4 MiB blocks, whose matches
    # reach past the window all the time
    big = [cut_blocks(members[m], s, 1)[0] for m, s in
           ((names[1], 1 << 20), (names[-1], 4 << 20))]
    cases["big_rows"] = batch(big, [0] * 2, [len(b) for b in big], 1,
                              np.zeros((2, U32_SLOTS), np.int32), [0] * 2)
    # F: the linked big-block frame's rows — ``[64 KiB window | 4 MiB block]``
    # parsed from cursor 65536 behind a table primed in the kernel, a short
    # last block, a 1 MiB block, and a first block (no window: laid out at
    # cursor 0 with a zero tail, unprimed); cap = block size, and the output
    # rows as wide as the frame writer makes them
    w = 65536
    src = members[names[1]]
    blk = min(4 << 20, (len(src) - w) // 3 // 16 * 16)  # 4 MiB at full scale
    span = src[len(src) // 3 :][: w + blk + blk // 3]
    first = members[names[5]][:blk]
    linked = [span[: w + blk], span[blk:], members[names[8]][-(w + min(blk, 1 << 20)) :],
              first + bytes(w)]
    lens = [len(r) - w for r in linked]
    cases["linked_big_rows"] = batch(linked, [w, w, w, 0], lens, 1,
                                     np.zeros((4, U32_SLOTS), np.int32), [1, 1, 1, 0])
    cases["linked_big_rows"][1][3] = len(first)  # the zero tail is not input
    out_caps = {"linked_big_rows": blk + 16}
    # G: the edges of the warp-wide parse.  Stale U16 and U32 tables behind a
    # table offset, on rows whose probes collide inside one batch (a run of
    # zeros, periods 2, 3 and 5) and on corpus rows, from cursor 0 and primed
    # in the kernel from cursor 100: a candidate forwarded between lanes must
    # take a slot's trip through the slot type and the offset
    collide = [bytes(60000), b"ab" * 30000, b"abc" * 20000, b"hello" * 12000] + small[:4]
    k = len(collide)
    for u16, slots, top in ((True, U16_SLOTS, 1 << 16), (False, U32_SLOTS, 1 << 32)):
        stale = np.array([[rnd.randrange(top) if rnd.random() < 0.5 else 0 for _ in range(slots)]
                          for _ in collide], dtype=np.uint32).view(np.int32)
        for toff in (40000, 65535, 70001):
            tag = f"{'u16' if u16 else 'u32'}_toff{toff}"
            cases[f"collide_{tag}"] = batch(collide, [0] * k, [-1] * k, 1, stale, [0] * k,
                                            [toff] * k)
            cases[f"collide_primed_{tag}"] = batch(collide, [100] * k, [-1] * k, 1, stale,
                                                   [1] * k, [toff] * k)
    # acceleration 8 on long incompressible rows, so steps pass 32 and one
    # batch spans more than a page; then a literal run of a megabyte before a
    # far copy shifted by one byte (a long backtrack), and the same tail
    # repeated three times (a backtrack across repeats)
    noise = rnd.randbytes((1 << 20) + 12345)
    far = [noise, noise + b"#" + noise[-60000:], noise + noise[-60000:] * 3]
    for accel in (1, 8):
        cases[f"incompressible_far_copy_accel{accel}"] = batch(
            far, [0] * 3, [-1] * 3, accel, np.zeros((3, U32_SLOTS), np.int32), [0] * 3)
    # rows of 0, 5, 12 and 13 bytes, and rows whose cursor is their end
    tiny = [b"", b"abcde", b"a" * 12, b"a" * 13, b"abcdabcdabcdabcdabcd", small[0][:3000]]
    cases["tiny_rows"] = batch(tiny, [0, 0, 0, 0, 20, 3000], [-1] * 6, 1,
                               np.zeros((6, U32_SLOTS), np.int32), [0, 0, 0, 0, 1, 1])
    # rows whose base is not 16-byte aligned: a width of 5 modulo 16
    odd = [b[:65536 - 11 * j] for j, b in enumerate(blocks[:6])]
    cases["odd_row_bases"] = batch(odd, [0] * 6, [-1] * 6, 1, np.zeros((6, U32_SLOTS), np.int32),
                                   [0] * 6, width=65536 + 5)
    odd = [dic + b[:60000] for b in blocks[:3]]
    cases["odd_row_bases_window"] = batch(odd, [65536] * 3, [60000] * 3, 1,
                                          np.zeros((3, U32_SLOTS), np.int32), [1] * 3,
                                          width=2 * 65536 + 7)
    # one row under every cap from 0 up: each group boundary aborts once, the
    # ones right after a ``cursor - 2`` re-insert among them (tables compared)
    row = blocks[0][:1500] + bytes(40) + rnd.randbytes(60)
    size = len(compress_whole(kc, row))
    caps = list(range(size + 2))
    cases["cap_sweep"] = batch([row] * len(caps), [0] * len(caps), caps, 1,
                               np.zeros((len(caps), U32_SLOTS), np.int32), [0] * len(caps))

    err = 0
    timing = {}
    for name, args in cases.items():
        width = args[0].shape[1]
        cap = out_caps.get(name, -(-compress_bound(width) // 16) * 16)
        t0 = time.perf_counter()
        want = kc.compress_plain(*args, cap)
        plain_ms = (time.perf_counter() - t0) * 1e3
        dev_args = [a.cuda() for a in args]
        got = kc.compress_batch(*dev_args, cap)
        torch.cuda.synchronize()
        err = max(err, same(f"compress[{name}]", got, want))
        n_rows = len(args[1])
        n_inc = int((want[2] == 1).sum())
        print(f"  compress[{name}]: {n_rows} blocks, {n_inc} incompressible, "
              f"equal to plain")
        if name == "u32_main":
            if not n_inc:
                fail("compress: no block of the capped batch was incompressible")
            ms = cuda_ms(lambda: kc.compress_batch(*dev_args, cap))
            moved = int(args[1].sum()) + int(want[1].sum()) + 2 * 4 * U32_SLOTS * len(args[1])
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                          shape=f"{n} x 64 KiB blocks, U32 tables, cap = block size")
        if name == "cap_sweep" and n_inc != n_rows - 2:
            fail(f"compress[cap_sweep]: {n_inc} of {n_rows} rows aborted")
        # the frame rows that carry the big-block paths, one row a launch
        for case, i, label in (("big_rows", 1, "one 4 MiB row"),
                               ("linked_big_rows", 0, "one [64 KiB window | 4 MiB block] row")):
            if name == case:
                one = [a[i : i + 1].contiguous() for a in dev_args]
                ms = cuda_ms(lambda: kc.compress_batch(*one, cap), reps=3)
                moved = int(args[1][i]) + int(want[1][i]) + 2 * 4 * U32_SLOTS
                timing.setdefault("at_frame_rows", {})[label] = dict(
                    ms=ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3, n=int(args[1][i]),
                    out=int(want[1][i]))
                print(f"  compress at the frame path's rows, {label} ({int(args[1][i]):,d} B -> "
                      f"{int(want[1][i]):,d} B): {ms:.3f} ms on the card, bound "
                      f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return dict(err=err, **timing)


def check_split(members):
    """compress.cu's split parse (a row cut at seams, a warp a segment, the
    pieces stitched) against its one-warp kernel: every 4 MiB block of each
    member in one launch, as the frame writer launches them (cap = block
    size).  Then three shapes held against the one-warp kernel and against
    the split parse's plain version on the same rows (``out``, ``out_len``,
    ``status`` and the seams; the seams taken over depend on which warp has
    published how far on the card, so they are printed, not compared): one
    4 MiB row of xml, the largest member's rows, and the split path's worst
    case, one random 4 MiB row (no search start in common: every seam taken
    over), whose time must stay within 1.25 times the one-warp kernel's.
    Returns the report."""
    import numpy as np
    import torch

    from lz4tpu_torch.kernels import compress as kc
    from lz4tpu_torch.parallel.blocks import block_lens
    from lz4tpu_torch.runtime import round_up
    from lz4tpu_torch.spec.table import U32_SLOTS

    block = 4 << 20
    width = round_up(block + 16, 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launches(data):
        lens = block_lens(len(data), block)
        arr = np.zeros((len(lens), block), np.uint8)
        arr.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
        rows = torch.from_numpy(arr).cuda()
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        zeros, ones = torch.zeros_like(n), torch.ones_like(n)
        tables = torch.zeros((len(lens), U32_SLOTS), dtype=torch.int32, device="cuda")
        seam = kc.split_seam(lens, sms)
        plan = None
        if seam is not None:
            plan = kc.split_plan(lens, seam)
            plan = plan._replace(warps=torch.from_numpy(plan.warps).cuda(),
                                 row_first=torch.from_numpy(plan.row_first).cuda())
        n_cpu = n.cpu()
        return lens, seam, {
            "one warp": lambda: kc.compress_batch(rows, n, zeros, n, ones, zeros, zeros, tables,
                                                  width),
            "split": lambda: kc.compress_split(rows, n, n, ones, seam, plan, width),
            "plain": lambda: kc.compress_split_plain(torch.from_numpy(arr), n_cpu, n_cpu,
                                                     torch.ones_like(n_cpu), seam, width)}

    def held(name, want, got):
        w_out, w_len, w_st = (t.cpu() for t in want[:3])
        g_out, g_len, g_st = (t.cpu() for t in got[:3])
        ok = w_st == 0
        if not (torch.equal(w_st, g_st) and torch.equal(w_len[ok], g_len[ok])
                and torch.equal(w_out[ok], g_out[ok]) and not g_out[~ok].any()):
            fail(f"compress_split[{name}]: differs from the one-warp kernel")
        return got[3].cpu()

    def held_by_plain(name, plain, got):
        p_out, p_len, p_st, p_counts = plain
        g_out, g_len, g_st, g_counts = (t.cpu() for t in got)
        if not (torch.equal(p_st, g_st) and torch.equal(p_len, g_len)
                and torch.equal(p_out, g_out) and torch.equal(p_counts[0], g_counts[0])):
            fail(f"compress_split[{name}]: differs from its plain version")
        return int(p_counts[1].sum())

    seams = taken = rows_split = 0
    for name, data in members.items():
        lens, seam, calls = launches(data)
        if seam is None:
            print(f"  compress_split[{name}]: {len(lens)} rows, none long enough to split")
            continue
        counts = held(name, calls["one warp"](), calls["split"]())
        seams += int(counts[0].sum())
        taken += int(counts[1].sum())
        rows_split += len(lens)
        print(f"  compress_split[{name}]: {len(lens)} rows at seams {seam:,d} B apart, "
              f"{int(counts[0].sum())} seams, {int(counts[1].sum())} taken over; equal to the "
              f"one-warp kernel")
    if not rows_split:
        fail("compress_split: no member's rows took the split parse")
    print(f"  compress_split: {rows_split} rows, {seams} seams, {taken} taken over "
          f"(compress_seams, compress_seams_taken_over)")

    largest = max(members, key=lambda m: len(members[m]))
    rnd = random.Random(0x5EED)
    shapes = {"one 4 MiB row of xml": members["xml"][:block],
              f"{largest}, {len(block_lens(len(members[largest]), block))} rows":
                  members[largest],
              "one random 4 MiB row": rnd.randbytes(block)}
    timing = {}
    for label, data in shapes.items():
        lens, seam, calls = launches(data)
        if seam is None:
            continue
        got = calls["split"]()
        counts = held(label, calls["one warp"](), got)
        t0 = time.perf_counter()
        plain = calls["plain"]()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_taken = held_by_plain(label, plain, got)
        ms = in_turns(("one warp", "split"), calls)
        bound = (len(data) + 2 * 4 * U32_SLOTS * len(lens)) / HBM_BYTES_PER_S * 1e3
        timing[label] = dict(one_warp_ms=ms["one warp"], split_ms=ms["split"], seam=seam,
                             seams=int(counts[0].sum()), taken_over=int(counts[1].sum()),
                             plain_taken_over=plain_taken, plain_ms=plain_ms, bound_ms=bound)
        print(f"  compress_split at {label}: {ms['split']:.3f} ms, one warp a row "
              f"{ms['one warp']:.3f} ms ({ms['one warp'] / ms['split']:.2f}x), seams "
              f"{seam:,d} B apart, {int(counts[0].sum())} seams, {int(counts[1].sum())} taken "
              f"over (plain version: {plain_taken}), bound {bound:.4f} ms; equal to the "
              f"one-warp kernel and to the plain version ({plain_ms:.1f} ms on the host)")
    worst = timing["one random 4 MiB row"]
    if worst["split_ms"] > 1.25 * worst["one_warp_ms"]:
        fail(f"compress_split: the random row took {worst['split_ms']:.3f} ms, over 1.25 "
             f"times the one-warp kernel's {worst['one_warp_ms']:.3f} ms")
    first = timing.get("one 4 MiB row of xml") or next(iter(timing.values()))
    return dict(err=0, ms=first["split_ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], shape="one 4 MiB row of xml, seams by split_seam",
                at_frame_rows=timing, seams=seams, taken_over=taken)


def compress_whole(kc, row: bytes) -> bytes:
    """``row`` through the compressor's plain version, no cap."""
    from lz4tpu_torch.spec.table import U32_SLOTS

    payload, _ = kc.parse_plain(row, 0, -1, 1, 0, False, [0] * U32_SLOTS, False, 2 * len(row) + 16)
    return payload


def lane_edge_payloads():
    """The edge payloads of tests/test_compress128.py: (payload, hashlog)."""
    rnd = random.Random(0xED6E)
    v1 = bytes([99, 116, 232, 245])
    v2 = bytes([180, 163, 115, 4])  # same bucket and tag as v1 at hashlog 10
    collide = rnd.randbytes(40) + v1 + rnd.randbytes(40) + v2 + rnd.randbytes(40)
    plain = [b"", b"hello", b"x" * 13, b"\x00" * 12000, rnd.randbytes(3000),
             b"Q" * 9000 + rnd.randbytes(2200), b"ab" * 200, bytes(range(256))]
    return [(p, 12) for p in plain] + [(collide, 10), (collide + collide[:60], 10)]


def check_compress128(members):
    """The lane compressor against its plain versions in its three modes, and
    STRICT also against the greedy compressor's kernel; returns the report."""
    import numpy as np
    import torch

    from lz4tpu_torch.kernels import compress128 as c128
    from lz4tpu_torch.kernels.compress import compress_blocks
    from lz4tpu_torch.spec.table import U32Table

    labels = ("out", "out_len", "tail_pos", "tail_lit")
    names = list(members)
    w = 65536

    def run(name, tensors, **kw):
        """Kernel against plain on one batch; returns (kernel tensors, plain
        tensors, plain ms)."""
        t0 = time.perf_counter()
        want = c128.compress128(*tensors, **kw)
        plain_ms = (time.perf_counter() - t0) * 1e3
        dev = [t.cuda() for t in tensors]
        got = c128.compress128(*dev, **kw)
        torch.cuda.synchronize()
        same(f"compress128[{name}]", got, want, labels)
        n_in = int((tensors[2] - tensors[3]).sum())
        print(f"  compress128[{name}]: {len(tensors[1])} rows, {n_in:,d} B -> "
              f"{int(want[1].sum()):,d} B, equal to plain")
        return dev, want, plain_ms

    def tensors_of(blocks, prefixes=None):
        flat, base, n, cur0 = c128.pack_lane_rows(blocks, prefixes)
        return (torch.from_numpy(flat.copy()), torch.from_numpy(base), torch.from_numpy(n),
                torch.from_numpy(cur0))

    def moved(tensors, want):
        """Bytes the launch must move: the source once, the streams once,
        and the per-row scalars in and out."""
        return tensors[0].numel() + int(want[1].sum()) + 28 * len(tensors[1])

    # default mode at the shape the kernel is reported at: 128 chunks of
    # 32 KiB spread over the members
    chunks = [b for m in names for b in cut_blocks(members[m], c128.MAX_B, 11)][:128]
    main = tensors_of(chunks)
    dev, want, plain_ms = run("default, 128 x 32 KiB", main)
    ms = cuda_ms(lambda: c128.compress128(*dev))
    report = dict(err=0, ms=ms, plain_ms=plain_ms, bound_ms=moved(main, want) / HBM_BYTES_PER_S * 1e3,
                  shape=f"{len(chunks)} x 32 KiB chunks, default mode")

    # STRICT on the same chunks: plain version and the greedy compressor's kernel
    dev, want, strict_plain_ms = run("strict, 128 x 32 KiB", main, strict=True)
    strict_ms = cuda_ms(lambda: c128.compress128(*dev, strict=True))
    scalar, _ = compress_blocks(chunks, tables=[U32Table() for _ in chunks], device="cuda")
    lens = want[1].numpy()
    for i, c in enumerate(scalar):
        if want[0][i, : lens[i]].numpy().tobytes() != c:
            fail(f"compress128[strict]: chunk {i} differs from the greedy compressor's kernel")
    print(f"  compress128[strict]: {len(chunks)} chunks equal to compress.cu; {strict_ms:.3f} ms "
          f"on the card against {ms:.3f} ms in default mode, plain {strict_plain_ms:.1f} ms")

    # the edge payloads, default and STRICT (an empty block is b"\x00" in the
    # lane kernel and nothing in the greedy one)
    for hashlog in (12, 10):
        edge = [p for p, h in lane_edge_payloads() if h == hashlog]
        run(f"default, edge payloads, hashlog {hashlog}", tensors_of(edge), hashlog=hashlog)
    edge = [p for p, _ in lane_edge_payloads()]
    _, want, _ = run("strict, edge payloads", tensors_of(edge), strict=True)
    scalar, _ = compress_blocks(edge, tables=[U32Table() for _ in edge], device="cuda")
    lens = want[1].numpy()
    for i, (p, c) in enumerate(zip(edge, scalar)):
        if want[0][i, : lens[i]].numpy().tobytes() != (c if p else b"\x00"):
            fail(f"compress128[strict]: edge payload {i} differs from the greedy compressor's kernel")

    # window mode: full, short, unprimed (under 16 bytes) and absent windows
    # in one batch, short blocks among them, and a head chunk behind the
    # tail of a dictionary that is not the input before it
    blocks, prefixes = [], []
    kinds = (w, 3000, 10, 0, w, 40000)
    for k, m in enumerate(names):
        data = members[m]
        pos = min(w + 4096 * k, max(len(data) - c128.MAX_B, 0))
        size = c128.MAX_B if k % 4 else 5000 + 1000 * k
        blocks.append(data[pos : pos + size])
        prefixes.append(data[max(pos - kinds[k % len(kinds)], 0) : pos])
    dic = members[names[0]][-w:]
    blocks += [members[m][: c128.MAX_B] for m in names[5:9]]
    prefixes += [dic, dic[-20000:], dic, dic[:15]]
    window_rows = tensors_of(blocks, prefixes)
    run("window, mixed windows and dictionary heads", window_rows)
    spread = sorted({int(c) for c in window_rows[3]})
    full = spread[-1] == w or min(map(len, members.values())) < 3 * w  # a small --scale
    if not (spread[0] == 0 and 0 < spread[1] < 16 and full and len(spread) >= 5):
        fail(f"compress128[window]: the batch lacks a window kind: {spread}")

    # the frame path's own rows: three 4 MiB blocks (shorter at small scale)
    # cut into chunks, each behind the 64 KiB before it inside its block
    big = [cut_blocks(members[m], 4 << 20, 1)[0] for m in names[:3]]
    flat = np.frombuffer(b"".join(big), np.uint8)
    base, n, cur0 = [], [], []
    floor = 0
    for b in big:
        for start in range(floor, floor + len(b), c128.MAX_B):
            lo = max(start - w, floor)
            base.append(lo)
            cur0.append(start - lo)
            n.append(start - lo + min(c128.MAX_B, floor + len(b) - start))
        floor += len(b)
    frame_rows = (torch.from_numpy(flat.copy()), torch.tensor(base, dtype=torch.int64),
                  torch.tensor(n, dtype=torch.int32), torch.tensor(cur0, dtype=torch.int32))
    dev, want, big_plain_ms = run("window, chunks of 3 x 4 MiB blocks", frame_rows)
    big_ms = cuda_ms(lambda: c128.compress128(*dev))
    label = (f"{len(base)} chunks of " + " + ".join(f"{len(b) / (1 << 20):.2f}" for b in big)
             + " MiB blocks, in-block windows")
    report["at_frame_rows"] = {label: dict(
        ms=big_ms, plain_ms=big_plain_ms,
        bound_ms=moved(frame_rows, want) / HBM_BYTES_PER_S * 1e3)}
    print(f"  compress128 at the frame path's rows ({label}): {big_ms:.3f} ms on the card, plain "
          f"{big_plain_ms:.1f} ms, bound {report['at_frame_rows'][label]['bound_ms']:.4f} ms")

    # one linked frame's launch (5c): the 32 chunks of a 1 MiB segment, each
    # behind the 64 KiB before it
    seg = cut_blocks(members[names[1]], 1 << 20, 3)[1]
    chunks = [seg[i : i + c128.MAX_B] for i in range(0, len(seg), c128.MAX_B)]
    windows = [seg[max(i - w, 0) : i] for i in range(0, len(seg), c128.MAX_B)]
    linked_rows = tensors_of(chunks, windows)
    dev, want, linked_plain_ms = run("window, the 32 chunks of a linked 1 MiB segment", linked_rows)
    linked_ms = cuda_ms(lambda: c128.compress128(*dev))
    label = f"{len(chunks)} rows of [64 KiB window | 32 KiB] (a linked 1 MiB segment)"
    report["at_frame_rows"][label] = dict(
        ms=linked_ms, plain_ms=linked_plain_ms,
        bound_ms=moved(linked_rows, want) / HBM_BYTES_PER_S * 1e3)
    print(f"  compress128 on {label}: {linked_ms:.3f} ms on the card, plain {linked_plain_ms:.1f} ms, "
          f"bound {report['at_frame_rows'][label]['bound_ms']:.4f} ms")
    return report


def hostile_blocks(valid, rng):
    """Seeded hostile inputs: truncations, byte flips, and hand-made zero
    offset, offset past the prefix, stray trailing byte, memory limit."""
    out = [
        b"\x10A\x00\x00",  # zero offset
        b"\x10A\x05\x00",  # offset past prefix + output
        b"\x1fA\x01\x00" + b"\xff" * 300 + b"\x00",  # match past the limit
        b"\xf0",  # literal LSIC runs off the end
        b"\x40ab",  # literals run off the end
    ]
    for v in valid:
        out.append(v + b"\x00")  # stray trailing byte, literal nibble 0: clean end
        out.append(v + b"\x10")  # stray trailing byte with literals: unexpected end
        out.append(v[: rng.randrange(1, len(v))])
        b = bytearray(v)
        for _ in range(3):
            b[rng.randrange(len(b))] = rng.getrandbits(8)
        out.append(bytes(b))
    return out


def mutate(r: random.Random, buf: bytes, depth: int = 0) -> bytes:
    """One seeded mutation of a compressed block."""
    b = bytearray(buf)
    if not b:
        return r.randbytes(r.randrange(1, 8))
    op = r.randrange(8)
    if op == 0:  # single bit flip
        b[r.randrange(len(b))] ^= 1 << r.randrange(8)
    elif op == 1:  # byte substitution
        b[r.randrange(len(b))] = r.getrandbits(8)
    elif op == 2:  # truncation
        del b[r.randrange(len(b)):]
    elif op == 3:  # length-field corruption: extreme LE value at any spot
        p = r.randrange(len(b))
        w = r.choice((1, 2, 4))
        val = r.choice((0, 1, 0xFE, 0xFFFF, 0x00FFFFFF, 0x7FFFFFFF, 1 << 31, 0xFFFFFFFF))
        b[p : p + w] = val.to_bytes(4, "little")[:w]
    elif op == 4:  # insert junk
        p = r.randrange(len(b) + 1)
        b[p:p] = r.randbytes(r.randrange(1, 6))
    elif op == 5:  # duplicate an internal slice elsewhere
        p = r.randrange(len(b))
        ln = r.randrange(1, min(64, len(b) - p) + 1)
        q = r.randrange(len(b) + 1)
        b[q:q] = b[p : p + ln]
    elif op == 6:  # delete a slice
        p = r.randrange(len(b))
        del b[p : p + r.randrange(1, min(32, len(b) - p) + 1)]
    elif depth < 3:  # stacked mutations
        return mutate(r, mutate(r, bytes(b), depth + 1), depth + 1)
    return bytes(b)


def lsic(v: int) -> bytes:
    return b"" if v < 15 else b"\xff" * ((v - 15) // 255) + bytes([(v - 15) % 255])


def seq(lit: bytes = b"", offset: int = 0, ml: int = 0) -> bytes:
    """One LZ4 sequence; ``ml == 0``: literals only (a block's last one)."""
    if not ml:
        return bytes([min(len(lit), 15) << 4]) + lsic(len(lit)) + lit
    return (bytes([(min(len(lit), 15) << 4) | min(ml - 4, 15)]) + lsic(len(lit)) + lit
            + offset.to_bytes(2, "little") + lsic(ml - 4))


def decoder_edge_streams():
    """Hand-made streams for the edges of a parse that takes 32 sequences at
    a time (limit 2048): batches that fill exactly, by one less and by one
    more, every match reading the one before it; every way a stream may end
    at a batch boundary (literals, a match, a stray byte that re-reads as a
    token, cleanly or not); each error kind at entry 0, 1 and 31 of a batch
    and 0 of the next, with a later error behind it; matches that read older
    output, their own literals and the sequences before them in one batch."""
    minimal = seq(b"", 4, 4)
    blocks, prefixes = [], []
    for count in (1, 31, 32, 33, 64, 65):
        body = seq(b"abcd", 4, 4) + minimal * (count - 1)
        for tail in (seq(b"xyz"), b"", b"\x00", b"\x10"):
            blocks.append(body + tail)
            prefixes.append(b"")
    bad = (seq(b"", 0, 4), seq(b"", 0xFFFF, 4), seq(b"", 4, 4000), b"\xf0\xff\xff\xff")
    for entry in (0, 1, 31, 32):
        for b in bad:
            blocks.append(minimal * entry + b + bad[0] + seq(b"zz"))
            prefixes.append(b"wxyz")
    blocks.append(seq(b"AB", 150, 20) + seq(b"CDEF", 4, 12) + seq(b"", 30, 25) + seq(b"G", 60, 59)
                  + seq(b"HI", 3, 40) + seq(b"tail"))
    prefixes.append(bytes(range(200)))
    return blocks, prefixes


def decoder_window_streams(r: random.Random, count: int = 24, out_limit: int = 0):
    """Seeded streams of about 300 KiB whose sequences carry length runs,
    long literal runs and long matches all along, so that the ends of the
    decoder's moving window fall inside tokens' length runs, literals and
    offsets at many phases, and sequences longer than 8 KiB sit among short
    ones.  With ``out_limit`` (decode128's 64 KiB blocks): literal-heavy
    streams whose output stays under it, so the stream is several of
    decode128's windows long, with sequences longer than its batches.
    Returns (blocks, the largest output size)."""
    lits = (0, 1, 14, 15, 16, 40, 269, 270, 300, 700, 1200) + ((4500,) if out_limit else ())
    mls = (4, 5, 18, 19, 20, 273, 274, 300) + ((600, 5000) if out_limit else (2000, 9000))
    blocks, largest = [], 0
    for _ in range(count):
        out, size = bytearray(seq(r.randbytes(64), 64, 8)), 72
        while len(out) < 300_000 and (not out_limit or size + 9600 < out_limit):
            lit = r.choice(lits)
            ml = r.choice(mls)
            size += lit
            out += seq(r.randbytes(lit), r.randrange(1, min(size, 65535) + 1), ml)
            size += ml
        blocks.append(bytes(out + seq(r.randbytes(r.randrange(0, 40)))))
        largest = max(largest, size + 40)
    return blocks, largest


def desync_stream(rng, repeats: int, valid: bool = True, phase: int = 1) -> bytes:
    """A stream on which walks from segment starts stay out of step with
    the true chain.  A lead sequence (12 or 14 seeded literals, a match of
    4 at offset 4) is followed by ``repeats`` times the 4-byte sequence
    ``10 10 10 00`` (one literal, offset 16, a match of 4).  Parsed from any
    other phase of that pattern the bytes form chains of their own that
    never meet the true one, and the lead puts every multiple of 4 at
    ``phase`` (1 or 3) of it: with a segment size that is a multiple of 4,
    every segment but the first starts out of step and a round of walks
    brings one more into step.  ``valid=False`` ends the stream with a
    match that reaches before the output."""
    lit = {1: 12, 3: 14}[phase]
    head = bytes([lit << 4]) + bytes(rng.randrange(256) for _ in range(lit)) + b"\x04\x00"
    tail = b"\x30end" if valid else b"\x00\xff\xff"
    return head + b"\x10\x10\x10\x00" * repeats + tail


def desync_streams():
    """Streams on which decode_v4's walks from segment starts never fall
    into step with the true chain, long enough at its segment size to need
    the serial finish behind its rounds: valid and ending in an invalid
    offset, at both phases."""
    from lz4tpu_torch.kernels.decompress_v4 import ROUNDS, SEGMENT

    r = random.Random(0xDE5C)
    repeats = (ROUNDS + 4) * SEGMENT // 4
    return [desync_stream(r, repeats, valid, phase) for valid in (True, False) for phase in (1, 3)]


def v4_groups(args, limit: int) -> int:
    """The groups of blocks in which decode_v4's kernels take this batch
    (as many blocks a group as its scratch budget holds)."""
    from lz4tpu_torch import build
    from lz4tpu_torch.kernels.decode128 import round_up

    comp = args[0]
    group = build.load().lz4t_decode_v4_group(comp.shape[0], comp.shape[1],
                                              round_up(limit + comp.shape[1], 16))
    return -(-comp.shape[0] // group)


def check_decoders(members):
    """The four decoders against their plain version (one function for all
    of them: they share a contract)."""
    import numpy as np
    import torch

    from lz4tpu_torch.kernels import decode128 as d128
    from lz4tpu_torch.kernels import decodebig as dbig
    from lz4tpu_torch.kernels import decompress_v3 as dv3
    from lz4tpu_torch.kernels import decompress_v4 as dv4
    from lz4tpu_torch.kernels.compress import compress_blocks
    from lz4tpu_torch.kernels.pack import pack_rows
    from lz4tpu_torch.spec.table import U32Table

    decoders = {"decode128": d128.decode128, "decode_v4": dv4.decode_v4,
                "decode_big": dbig.decode_big, "decode_v3": dv3.decode_v3}
    rng = random.Random(0x5EED)
    names = list(members)

    def tensors(blks, pfx):
        c, cl = pack_rows(blks, "cpu")
        p, pl = pack_rows(pfx, "cpu", align_right=True)
        return c, cl, p, pl

    def plain(args, limit):
        t0 = time.perf_counter()
        want = d128.decode_plain(*args, limit, -(-(limit + args[0].shape[1]) // 16) * 16)
        return want, (time.perf_counter() - t0) * 1e3

    def behind_prefix(rows):
        """Rows ``[64 KiB prefix | block]`` compressed from cursor 64 KiB:
        blocks whose offsets reach into the prefix."""
        comp, _ = compress_blocks(rows, cursors=[65536] * len(rows),
                                  tables=[U32Table() for _ in rows], prime_prefix=True,
                                  device="cuda")
        return [(c, r[:65536]) for c, r in zip(comp, rows) if c is not None]

    per = 16
    raw = [b for m in names for b in cut_blocks(members[m], 65536, per)]
    comp, _ = compress_blocks(raw, device="cuda")
    comp = [c if c is not None else b"" for c in comp]
    pairs = behind_prefix([b for m in names[:4] for b in cut_blocks(members[m], 2 * 65536, 8)])
    blocks = comp + [c for c, _ in pairs]
    prefixes = [b""] * len(comp) + [p for _, p in pairs]
    hostile = hostile_blocks(comp[:: max(len(comp) // 16, 1)], rng)
    blocks += hostile
    prefixes += [rng.choice([b"", raw[0][:300]]) for _ in hostile]

    args = tensors(blocks, prefixes)
    want, _ = plain(args, 65536)
    st = want[2].numpy()
    kinds = {int(s): int((st == s).sum()) for s in np.unique(st)}
    if len(kinds) < 5:
        fail(f"decoders: the hostile batch did not reach every status: {kinds}")
    report = {}
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in args), 65536)
        torch.cuda.synchronize()
        report[name] = dict(err=same(name, got, want))
        print(f"  {name}: {len(blocks)} blocks (statuses {kinds}), equal to plain")
    # the same batch in rows 5 bytes wider: rows then start off the 16-byte
    # grid that decode_big and decode_v3 load the compressed stream on
    odd = (torch.nn.functional.pad(args[0], (0, 5)), *args[1:])
    want, _ = plain(odd, 65536)
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in odd), 65536)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[odd rows]", got, want))
    print(f"  all four on rows of {odd[0].shape[1]} bytes (not a multiple of 16): equal to plain")

    # the edges of decode_big's parse, which takes 32 sequences at a time
    blocks, prefixes = decoder_edge_streams()
    eargs = tensors(blocks, prefixes)
    want, _ = plain(eargs, 2048)
    st = want[2].numpy()
    kinds = {int(s): int((st == s).sum()) for s in np.unique(st)}
    if len(kinds) < 5:
        fail(f"decoders: the edge streams did not reach every status: {kinds}")
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in eargs), 2048)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[edge streams]", got, want))
    blocks, largest = decoder_window_streams(random.Random(0x3E4D))
    wargs = tensors(blocks, [b""] * len(blocks))
    wlimit = -(-largest // 16) * 16
    want, _ = plain(wargs, wlimit)
    if int((want[2] != 0).sum()):
        fail("decoders: a window stream is not valid")
    for name in ("decode_v4", "decode_big", "decode_v3"):
        got = decoders[name](*(a.cuda() for a in wargs), wlimit)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[window streams]", got, want))
    print(f"  {len(eargs[1])} edge streams (statuses {kinds}) on all four, {len(blocks)} streams of "
          f"{len(blocks[0]):,d} B with length runs and long sequences all along on v4, big and "
          f"v3: equal to plain")
    blocks, largest = decoder_window_streams(random.Random(0x3E4E), 32, 65536)
    wargs = tensors(blocks, [b""] * len(blocks))
    want, _ = plain(wargs, 65536)
    if int((want[2] != 0).sum()) or largest > 65536:
        fail("decoders: a 64 KiB window stream is not valid")
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in wargs), 65536)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"],
                                  same(f"{name}[64 KiB window streams]", got, want))
    print(f"  {len(blocks)} literal-heavy streams of {min(map(len, blocks)):,d}-"
          f"{max(map(len, blocks)):,d} B into at most 64 KiB, on all four: equal to plain")

    # seeded mutations of compressed blocks, half behind a prefix they may
    # reach into: 3,000 of small blocks and 600 random strings (limit 8 KiB),
    # then 150 of 256 KiB blocks (limit 256 KiB; decode128 holds 64 KiB)
    fuzz = random.Random(0x70C4)
    data = members[names[0]]
    small = [data[k << 14 :][: 2048 + 512 * k] for k in range(12)]
    seeds = [c for c in compress_blocks(small, device="cuda")[0] if c is not None]
    blocks = [mutate(fuzz, fuzz.choice(seeds)) for _ in range(3000)]
    blocks += [fuzz.randbytes(fuzz.randrange(0, 300)) for _ in range(600)]
    fargs = tensors(blocks, [fuzz.choice([b"", b"", data[:3000], data[:7]]) for _ in blocks])
    want, _ = plain(fargs, 8192)
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in fargs), 8192)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[mutated small]", got, want))
    n_bad = int((want[2] != 0).sum())
    seeds = [c for c in compress_blocks(cut_blocks(data, 1 << 18, 4), device="cuda")[0]
             if c is not None]
    blocks = [mutate(fuzz, fuzz.choice(seeds)) for _ in range(150)]
    fargs = tensors(blocks, [fuzz.choice([b"", data[-65536:]]) for _ in blocks])
    want, _ = plain(fargs, 1 << 18)
    for name in ("decode_v4", "decode_big", "decode_v3"):
        got = decoders[name](*(a.cuda() for a in fargs), 1 << 18)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[mutated 256 KiB]", got, want))
    print(f"  3,600 mutated small blocks ({n_bad} refused) on all four, 150 mutated 256 KiB "
          f"blocks ({int((want[2] != 0).sum())} refused) on v4, big and v3: equal to plain")

    # streams on which decode_v4's walks never fall into step by themselves:
    # its serial finish, on all four
    blocks = desync_streams()
    dargs = tensors(blocks, [b""] * len(blocks))
    want, _ = plain(dargs, 65536)
    for name, fn in decoders.items():
        got = fn(*(a.cuda() for a in dargs), 65536)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[desync streams]", got, want))
    print(f"  {len(blocks)} desync streams of {len(blocks[0]):,d} B (statuses "
          f"{sorted(set(want[2].tolist()))}) on all four: equal to plain")

    # timing at decode128's main-path shape: the valid 64 KiB blocks, no
    # prefix; decode128 and decode_v3 are reported at it, the others printed
    targs = tensors(comp, [b""] * len(comp))
    _, plain_ms = plain(targs, 65536)
    moved = int(targs[1].sum()) + sum(len(r) for r in raw)
    dev = [a.cuda() for a in targs]
    shape = f"{len(comp)} x 64 KiB blocks"
    at_128 = {name: cuda_ms(lambda fn=fn: fn(*dev, 65536)) for name, fn in decoders.items()}
    for name in ("decode128", "decode_v3"):
        report[name].update(ms=at_128[name], plain_ms=plain_ms,
                            bound_ms=moved / HBM_BYTES_PER_S * 1e3, shape=shape)
    report["decode128"]["decode_big_ms"] = at_128["decode_big"]
    print(f"  at decode128's shape ({shape}): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in at_128.items()))
    report["decode_v4"]["at_frame_rows"] = {shape: dict(
        ms=at_128["decode_v4"], bound_ms=moved / HBM_BYTES_PER_S * 1e3,
        decode128_ms=at_128["decode128"], decode_big_ms=at_128["decode_big"])}
    # a member's whole batch (mozilla's 782 blocks): decode_v3 beside
    # decode128, in turns; decode_v4 takes it in groups of blocks
    name = names[1]
    raws = [members[name][i : i + 65536] for i in range(0, len(members[name]), 65536)]
    kept = [(c, r) for c, r in zip(compress_blocks(raws, device="cuda")[0], raws) if c is not None]
    mcomp = [c for c, _ in kept]
    margs = tensors(mcomp, [b""] * len(mcomp))
    dev = [a.cuda() for a in margs]
    want, _ = plain(margs, 65536)
    for name in ("decode_v3", "decode128", "decode_v4"):
        report[name]["err"] = max(report[name]["err"],
                                  same(f"{name}[a member's batch]", decoders[name](*dev, 65536), want))
    print(f"  {len(mcomp)} blocks of {names[1]} on decode_v3, decode128 and decode_v4 "
          f"({v4_groups(dev, 65536)} groups): equal to plain")
    name = names[1]
    at_member = in_turns(("decode_v3", "decode128"),
                         {k: (lambda fn=decoders[k]: fn(*dev, 65536)) for k in decoders})
    moved = int(margs[1].sum()) + sum(len(r) for _, r in kept)
    label = f"{name}'s {len(mcomp)} blocks of 64 KiB"
    report["decode_v3"]["at_frame_rows"] = {label: dict(
        ms=at_member["decode_v3"], bound_ms=moved / HBM_BYTES_PER_S * 1e3,
        decode128_ms=at_member["decode128"])}
    print(f"  {label}: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in at_member.items())
          + f", bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
    # one block alone behind a 64 KiB prefix: what a wave of a linked frame
    # of 64 KiB blocks waits for (5d), on decode128 and decode_big
    ((one_comp, one_prefix),) = behind_prefix([cut_blocks(members[names[7]], 2 * 65536, 3)[1]])
    oargs = tensors([one_comp], [one_prefix])
    want, _ = plain(oargs, 65536)
    if int(want[2][0]) or int(want[1][0]) != 65536:
        fail("decoders: the block behind a prefix does not decode")
    dev = [a.cuda() for a in oargs]
    moved = len(one_comp) + 65536 + len(one_prefix)
    label = "one 64 KiB block behind a 64 KiB prefix"
    trio = ("decode128", "decode_big", "decode_v4")
    for name in trio:
        report[name]["err"] = max(report[name]["err"],
                                  same(f"{name}[{label}]", decoders[name](*dev, 65536), want))
    at_one = in_turns(trio, {k: (lambda fn=decoders[k]: fn(*dev, 65536)) for k in trio})
    report["decode128"]["at_frame_rows"] = {label: dict(
        ms=at_one["decode128"], bound_ms=moved / HBM_BYTES_PER_S * 1e3, n=len(one_comp),
        out=65536, decode_big_ms=at_one["decode_big"])}
    report["decode_v4"]["at_frame_rows"][label] = dict(
        ms=at_one["decode_v4"], bound_ms=moved / HBM_BYTES_PER_S * 1e3, n=len(one_comp),
        out=65536, decode128_ms=at_one["decode128"], decode_big_ms=at_one["decode_big"])
    print(f"  {label} of {names[7]} ({len(one_comp):,d} B in): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in at_one.items())
          + f", bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms")

    # big blocks, beyond the TPU kernels' windows: 256 KiB, 1 MiB and 4 MiB,
    # without a prefix, behind a 64 KiB prefix, and with that prefix cut to
    # 300 bytes (offsets that reach before it are invalid)
    sizes = [1 << 18, 1 << 20, 4 << 20]
    limit = max(sizes)
    big_raw = [cut_blocks(members[m], s, 1)[0] for s in sizes for m in names[:3]]
    big_comp, _ = compress_blocks(big_raw, device="cuda")
    if any(c is None for c in big_comp):
        fail("decoders: a big block of the stand-in did not compress")
    pairs = behind_prefix([cut_blocks(members[m], 65536 + s, 2)[1] for s in sizes
                           for m in names[3:5]])
    reach_302 = b"\x10A\x2e\x01"  # valid behind 64 KiB, invalid behind 300 bytes
    blocks = big_comp + ([c for c, _ in pairs] + [reach_302]) * 2
    prefixes = ([b""] * len(big_comp) + [p for _, p in pairs] + [pairs[0][1]]
                + [p[-300:] for _, p in pairs] + [pairs[0][1][-300:]])
    bargs = tensors(blocks, prefixes)
    want, _ = plain(bargs, limit)
    for i, r in enumerate(big_raw):
        if want[0][i, : len(r)].numpy().tobytes() != r:
            fail(f"decoders[big]: block {i} does not round-trip")
    st = want[2].numpy()
    kinds = {int(s): int((st == s).sum()) for s in np.unique(st)}
    if set(kinds) != {0, 4}:
        fail(f"decoders[big]: expected valid blocks and invalid offsets, got {kinds}")
    dev = [a.cuda() for a in bargs]
    for name in ("decode_v4", "decode_big", "decode_v3"):
        got = decoders[name](*dev, limit)
        torch.cuda.synchronize()
        report[name]["err"] = max(report[name]["err"], same(f"{name}[big]", got, want))
        groups = f", {v4_groups(dev, limit)} groups" if name == "decode_v4" else ""
        print(f"  {name}[big]: {len(blocks)} blocks of 256 KiB to 4 MiB (statuses {kinds}"
              f"{groups}), equal to plain")
    del dev, got

    # timing at the big-block shape: decode_v4 and decode_big are reported
    # at it, decode_v3 printed
    sizes = sizes[1:]
    skip = len(names[:3])  # the 256 KiB blocks come first
    targs = tensors(big_comp[skip:], [b""] * len(big_comp[skip:]))
    _, plain_ms = plain(targs, limit)
    moved = int(targs[1].sum()) + sum(len(r) for r in big_raw[skip:])
    dev = [a.cuda() for a in targs]
    shape = " + ".join(f"{len(names[:3])} x {s >> 20} MiB" for s in sizes) + " blocks"
    at_big = {name: cuda_ms(lambda fn=decoders[name]: fn(*dev, limit))
              for name in ("decode_v4", "decode_big", "decode_v3")}
    for name in ("decode_v4", "decode_big"):
        report[name].update(ms=at_big[name], plain_ms=plain_ms,
                            bound_ms=moved / HBM_BYTES_PER_S * 1e3, shape=shape)
    print(f"  at the big-block shape ({shape}): "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in at_big.items()))
    # one block of the largest size alone: what a wave of a linked frame waits for
    one = [a[-1:].contiguous() for a in dev]
    pair = ("decode_big", "decode_v4")
    at_one = in_turns(pair, {k: (lambda fn=decoders[k]: fn(*one, limit)) for k in pair})
    moved = int(targs[1][-1]) + len(big_raw[-1])
    for name in pair:
        report[name].setdefault("at_frame_rows", {})["one 4 MiB block"] = dict(
            ms=at_one[name], bound_ms=moved / HBM_BYTES_PER_S * 1e3, n=int(targs[1][-1]),
            out=len(big_raw[-1]))
    report["decode_v4"]["at_frame_rows"]["one 4 MiB block"]["decode_big_ms"] = at_one["decode_big"]
    print(f"  one block alone ({int(targs[1][-1]):,d} B -> {len(big_raw[-1]):,d} B): "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in at_one.items())
          + f", bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return report


def check_push_windows():
    """The slide of linked frames' windows (``kernels/window.py``) against
    its plain version: 64 rows of a wave, each with a window of its own
    length, new bytes of 0 to 65,552 bytes from decoded rows and from
    stored ones, rows that go to a permuted row of the next wave or
    nowhere; the launch timed at a wave of the ``silesia-64k-readbatch``
    cell's size (64 rows)."""
    import torch

    from lz4tpu_torch.kernels import window

    gen = torch.Generator().manual_seed(0x51DE)
    n, m, w = 64, 50, 1 << 16
    old = torch.randint(0, 256, (n, w), dtype=torch.uint8, generator=gen)
    old_len = torch.randint(0, w + 1, (n,), dtype=torch.int32, generator=gen)
    for width in (w + 16, 4096):  # a decoded wave's output rows, a stored wave's blocks
        data = torch.randint(0, 256, (n, width), dtype=torch.uint8, generator=gen)
        lens = torch.randint(0, width + 1, (n,), dtype=torch.int32, generator=gen)
        lens[:4] = torch.tensor([0, 1, w, width])[: 4].clamp(max=width).to(torch.int32)
        dest = torch.full((n,), -1, dtype=torch.int32)
        dest[torch.randperm(n, generator=gen)[:m]] = torch.randperm(m, generator=gen).to(
            torch.int32)
        want = (torch.zeros(m, w, dtype=torch.uint8), torch.zeros(m, dtype=torch.int32))
        window.push_windows_plain(old, old_len, data, lens, dest, *want)
        cuda = [t.cuda() for t in (old, old_len, data, lens, dest)]
        got = (torch.zeros(m, w, dtype=torch.uint8, device="cuda"),
               torch.zeros(m, dtype=torch.int32, device="cuda"))
        window.push_windows(*cuda, *got)
        torch.cuda.synchronize()
        same(f"push_windows (rows of {width} B)", got, want, ("new", "new_len"))
    ms = cuda_ms(lambda: window.push_windows(*cuda, *got))
    bound = 2 * m * w / HBM_BYTES_PER_S * 1e3
    print(f"  push_windows: {ms:.4f} ms a wave of {n} rows ({m} slid), bound {bound:.4f} ms")


def check_host_paths(members):
    """The C xxHash32 against the pure-Python one, and a whole frame made on
    the card against the same frame made by the plain versions."""
    import lz4tpu_torch as lt
    from lz4tpu_torch.spec.xxhash32 import XXHash32
    from lz4tpu_torch.utils.hashing import make_hasher

    data = min(members.values(), key=len)
    for n in (0, 1, 15, 16, 17, 1000, 65537):
        for split in (0, 3, n // 2):
            c = make_hasher(0x9E37, "cuda").update(data[:split]).update(data[split:n]).digest()
            p = XXHash32(0x9E37).update(data[:split]).update(data[split:n]).digest()
            if c != p:
                fail(f"xxh32: C {c:#x} != Python {p:#x} at {n} bytes, split {split}")
    sample = data[: 24 * 65536 + 1234]
    card = lt.compress_frame_parallel(sample, 65536, block_checksums=True)
    plain = lt.compress_frame_parallel(sample, 65536, block_checksums=True, device="cpu")
    if card != plain:
        fail("frame: the card's frame differs from the plain versions' frame")
    if lt.decompress_frame_parallel(plain, device="cpu") != sample:
        fail("frame: the plain frame does not round-trip")
    print(f"  xxh32: C equal to Python; frame of {len(sample):,d} B: card equal to plain")


def profile_calls(title, calls):
    """Host-side breakdown (cProfile) of each call, kernels on the card:
    where the wall time outside the kernels goes; then the device's share."""
    import cProfile
    import io
    import pstats

    for label, fn in calls:
        fn()  # warm: allocator, library
        prof = cProfile.Profile()
        prof.enable()
        fn()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        print(f"== profile: {label} of {title}, by own time")
        body = text.getvalue().splitlines()
        start = next(i for i, line in enumerate(body) if "ncalls" in line)
        for line in body[start:]:
            if line.strip():
                print("  " + line.rstrip()[:150])
        device_share(label, fn)


def profile_round_trip(members):
    """The largest member's round trip at 64 KiB independent blocks."""
    import lz4tpu_torch as lt

    name = max(members, key=lambda m: len(members[m]))
    data = members[name]
    frame = lt.compress_frame_parallel(data, 65536, content_checksum=True)
    profile_calls(f"{name} ({len(data):,d} B), 64 KiB independent blocks", (
        ("compress", lambda: lt.compress_frame_parallel(data, 65536, content_checksum=True)),
        ("decompress", lambda: lt.decompress_frame_parallel(frame)),
    ))


def profile_big_and_linked(members):
    """The largest member through phase 4: (a) 4 MiB independent blocks,
    (b) its 1 MiB segments as linked frames of 64 KiB blocks, (c) one
    linked frame of 4 MiB blocks."""
    import lz4tpu_torch as lt

    name = max(members, key=lambda m: len(members[m]))
    data = members[name]
    title = f"{name} ({len(data):,d} B)"
    frame = lt.compress_frame_parallel(data, 4 << 20)
    profile_calls(title + ", (a) 4 MiB independent blocks", (
        ("compress", lambda: lt.compress_frame_parallel(data, 4 << 20)),
        ("decompress", lambda: lt.decompress_frame_parallel(frame)),
    ))
    segments = [data[i : i + SEGMENT] for i in range(0, len(data), SEGMENT)]
    frames = [lt.compress_frame_parallel(seg, 65536, parallel_linked=True) for seg in segments]
    profile_calls(title + f", (b) {len(segments)} linked frames of 64 KiB blocks", (
        ("compress", lambda: [lt.compress_frame_parallel(seg, 65536, parallel_linked=True)
                              for seg in segments]),
        ("decompress", lambda: lt.decompress_frames_parallel(frames)),
    ))
    linked = lt.compress_frame_parallel(data, 4 << 20, parallel_linked=True)
    profile_calls(title + ", (c) one linked frame of 4 MiB blocks", (
        ("compress", lambda: lt.compress_frame_parallel(data, 4 << 20, parallel_linked=True)),
        ("decompress", lambda: lt.decompress_frames_parallel([linked])),
    ))


def device_share(label, fn):
    """Device time by kernel and copy (torch.profiler) over one call, and the
    share of the call's wall time in which the card was busy.  Only events
    on the device count (not the host operators that launched them, and
    not the profiler's own buffer requests)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    print(f"== device time: {label}, wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:9.3f} ms {count:5d} x {key[:90]}")


def frame_blocks(frame: bytes):
    """[(compressed?, payload offset, payload length)] of a frame made by
    this package's writer."""
    flg = frame[4]
    pos = 6 + (8 if flg & 0x08 else 0) + (4 if flg & 0x01 else 0) + 1
    blocks = []
    while True:
        ln = int.from_bytes(frame[pos : pos + 4], "little")
        pos += 4
        if ln == 0:
            return blocks
        blocks.append((not ln & (1 << 31), pos, ln & 0x7FFFFFFF))
        pos += (ln & 0x7FFFFFFF) + (4 if flg & 0x10 else 0)


def frame_stats(frame: bytes):
    """(compressed payload bytes, stored payload bytes, compressed-block
    count, stored-block count) of a frame made by this package's writer."""
    blocks = frame_blocks(frame)
    comp = [n for c, _, n in blocks if c]
    stored = [n for c, _, n in blocks if not c]
    return sum(comp), sum(stored), len(comp), len(stored)


def kernel_modules():
    from lz4tpu_torch.kernels import compress as kc
    from lz4tpu_torch.kernels import compress128 as c128
    from lz4tpu_torch.kernels import decode128 as d128
    from lz4tpu_torch.kernels import decodebig as dbig
    from lz4tpu_torch.kernels import decompress_v3 as dv3
    from lz4tpu_torch.kernels import decompress_v4 as dv4

    return (kc, c128, d128, dv4, dbig, dv3)


def kernel_stats():
    """Every kernel's ``KernelStats`` by name, with its module:
    ``compress.cu`` has two entry points, the one-warp kernel
    (``compress``) and the split parse (``compress_split``)."""
    return {k.name: (k, m) for m in kernel_modules()
            for k in (m.KERNEL, getattr(m, "SPLIT_KERNEL", None)) if k is not None}


def frame_kernel(data: bytes) -> str:
    """The ``compress.cu`` entry point (its launch counter) that ``data``'s
    independent 4 MiB-block frame takes on this card
    (``parallel.blocks.scalar_route``)."""
    from lz4tpu_torch.parallel.blocks import block_lens, scalar_route

    return scalar_route(block_lens(len(data), 4 << 20), None, False, "cuda")[0]


class PathMeter:
    """Launch counts, kernel time and least traffic of one driven path:
    every kernel's count is taken when the path begins and again when it
    ends, and a kernel the path must run fails the script if it never ran."""

    def __init__(self, path: str, needed):
        self.path = path
        self.needed = needed
        self.stats = {name: k for name, (k, _) in kernel_stats().items()}
        self.traffic = {name: 0 for name in self.stats}  # bytes each kernel must move
        for k in self.stats.values():
            k.reset(timing=True)
        self.start = launch_counts()

    def compressed(self, frame, n_in, row_extra=0, kernel="compress"):
        """Account one frame's compress launch: input rows (``row_extra``
        bytes of window or dictionary each), output, tables in and out."""
        comp_bytes, _, nc, ns = frame_stats(frame)
        self.traffic[kernel] += (n_in + (nc + ns) * row_extra + comp_bytes
                                 + 2 * 4 * 4096 * (nc + ns))

    def lane_compressed(self, frame, n_in, source_extra=0):
        """Account one frame's lane-compress launch: the flat source once
        (``source_extra`` bytes of dictionary tails in it), the streams that
        made it into the frame, and 28 bytes of scalars a chunk."""
        comp_bytes, stored, _, _ = frame_stats(frame)
        self.traffic["compress128"] += (n_in + source_extra + comp_bytes + stored
                                        + 28 * -(-n_in // 32768))

    def decoded(self, kernel, frame, n_out, prefix_bytes=0):
        """Account one frame's decode: compressed blocks in, their output
        and the prefix bytes they may read."""
        comp_bytes, stored, _, _ = frame_stats(frame)
        self.traffic[kernel] += comp_bytes + n_out - stored + prefix_bytes

    def kernel_ms(self):
        return {name: k.elapsed_ms() for name, k in self.stats.items()}

    def finish(self):
        import torch

        torch.cuda.synchronize()
        report = {}
        for name, k in self.stats.items():
            report[name] = dict(launches=k.launches - self.start[name], main_ms=k.elapsed_ms(),
                                main_bound_ms=self.traffic[name] / HBM_BYTES_PER_S * 1e3)
            k.reset()
        for name in self.needed:
            # compress.cu's scalar parse runs in either of its entry points
            names = ("compress", "compress_split") if name == "compress" else (name,)
            if sum(report[n]["launches"] for n in names) <= 0:
                fail(f"{self.path}: kernel {name} was never launched")
        print(f"  {self.path}: " + ", ".join(
            f"{n} {r['launches']} launches {r['main_ms']:.2f} ms"
            for n, r in report.items() if r["launches"]))
        return report


def phase_main(members, scale: float):
    import torch

    import lz4tpu_torch as lt

    meter = PathMeter("64 KiB independent blocks", ("compress", "decode128", "decode_v4", "decode_big"))
    total_in = total_out = 0
    frames_3 = {}  # phase 7 holds the mesh's frames equal to these
    t_comp = t_dec = 0.0
    print(f"main path: scale {scale}, 64 KiB blocks, content checksum")
    for name, data in members.items():
        torch.cuda.synchronize()
        ms0 = meter.kernel_ms()
        t0 = time.perf_counter()
        frame = lt.compress_frame_parallel(data, block_size=65536, content_checksum=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = lt.decompress_frame_parallel(frame)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != data:
            fail(f"main path: {name} does not round-trip")
        frames_3[name] = frame
        _, _, nc, ns = frame_stats(frame)
        meter.compressed(frame, len(data))
        meter.decoded("decode128", frame, len(data))
        total_in += len(data)
        total_out += len(frame)
        t_comp += t1 - t0
        t_dec += t2 - t1
        ms = {k: v - ms0[k] for k, v in meter.kernel_ms().items()}
        print(f"  {name:8s} {len(data):>11,d} B ratio {len(frame) / len(data):.4f} "
              f"compress {len(data) / (t1 - t0) / 1e6:8.1f} MB/s "
              f"decompress {len(data) / (t2 - t1) / 1e6:8.1f} MB/s "
              f"kernel ms: compress {ms['compress']:.2f} decode128 {ms['decode128']:.2f} "
              f"({nc} blocks decoded, {ns} stored)")
    # a dictionary frame (shared 64 KiB prefix) and a 4 MiB-block frame
    # (decompress_v4 by default; decode_big with lane_kernel=True)
    names = list(members)
    dic = members[names[0]][-65536:]
    data = members[names[7]]
    frame = lt.compress_frame_parallel(data, 65536, dictionary=dic, block_checksums=True)
    if lt.decompress_frame_parallel(frame, dictionary=dic) != data:
        fail("main path: dictionary frame does not round-trip")
    meter.compressed(frame, len(data), row_extra=len(dic))
    meter.decoded("decode128", frame, len(data), prefix_bytes=len(dic))
    print(f"  dictionary frame: {names[7]} with a 64 KiB dictionary, ratio "
          f"{len(frame) / len(data):.4f}, round trip equal")
    data = members[names[-1]]
    frame = lt.compress_frame_parallel(data, 4 << 20)
    if lt.decompress_frame_parallel(frame, lane_kernel=True) != data:
        fail("main path: 4 MiB-block frame does not round-trip on decode_big")
    if lt.decompress_frame_parallel(frame) != data:
        fail("main path: 4 MiB-block frame does not round-trip on decompress_v4")
    meter.compressed(frame, len(data), kernel=frame_kernel(data))
    meter.decoded("decode_big", frame, len(data))
    meter.decoded("decode_v4", frame, len(data))
    print(f"  4 MiB-block frame: {names[-1]}, ratio {len(frame) / len(data):.4f}, "
          f"round trip equal on decode_big and on decompress_v4")
    report = meter.finish()
    return report, rates("main path total", total_in, total_out, t_comp, t_dec), frames_3


def wall(fn):
    """(result, host wall seconds) of ``fn``, the card idle before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def rates(label, n_in, n_out, t_comp, t_dec) -> str:
    """Print a path's totals; returns them for a later path to print beside
    its own."""
    summary = (f"ratio {n_out / n_in:.4f}, compress {n_in / t_comp / 1e6:.1f} MB/s, "
               f"decompress {n_in / t_dec / 1e6:.1f} MB/s")
    print(f"  {label}: {n_in:,d} B in, {summary} (host wall, incl. transfers)")
    return summary


def phase_big_and_linked(members):
    """Big blocks and linked frames over the whole corpus; returns one
    report per part, the summaries, and (a)'s frames."""
    import lz4tpu_torch as lt

    total = sum(map(len, members.values()))
    reports = {}

    # (a) independent frames of 4 MiB blocks
    meter = PathMeter("(a) big blocks", ("compress", "decode_v4"))
    n_out = 0
    t_comp = t_dec = 0.0
    frames_4a = {}  # phase 6 holds the streaming writer's frames equal to these
    for name, data in members.items():
        frame, dt = wall(lambda: lt.compress_frame_parallel(data, 4 << 20, content_checksum=True))
        frames_4a[name] = frame
        t_comp += dt
        back, dt = wall(lambda: lt.decompress_frame_parallel(frame))
        t_dec += dt
        if back != data:
            fail(f"(a) big blocks: {name} does not round-trip")
        meter.compressed(frame, len(data), kernel=frame_kernel(data))
        meter.decoded("decode_v4", frame, len(data))
        n_out += len(frame)
    summaries = {"4a": rates("(a) 4 MiB independent blocks", total, n_out, t_comp, t_dec)}
    reports["a"] = meter.finish()

    # (b) 1 MiB segments as linked frames of 64 KiB blocks, decoded in waves
    segments = [data[i : i + SEGMENT] for data in members.values()
                for i in range(0, len(data), SEGMENT)]
    meter = PathMeter("(b) linked frames", ("compress", "decode128"))
    frames, t_comp = wall(lambda: [lt.compress_frame_parallel(seg, 65536, parallel_linked=True)
                                   for seg in segments])
    back, t_dec = wall(lambda: lt.decompress_frames_parallel(frames))
    if back != segments:
        fail("(b) linked frames: the segments do not round-trip")
    for seg, frame in zip(segments, frames):
        blocks = frame_blocks(frame)
        windows = sum(65536 for k, (c, _, _) in enumerate(blocks) if c and k)
        meter.compressed(frame, len(seg) + 65536 * (len(blocks) - 1))  # rows carry windows
        meter.decoded("decode128", frame, len(seg), prefix_bytes=windows)
    linked_total = sum(map(len, frames))
    frames_4b = frames
    summaries["4b"] = rates(f"(b) {len(segments)} linked frames of 64 KiB blocks, "
                            f"{max(len(frame_blocks(f)) for f in frames)} waves",
                            total, linked_total, t_comp, t_dec)
    reports["b"] = meter.finish()
    k = len(segments) // 2
    if lt.decompress_frame(frames[k]) != segments[k]:
        fail("(b) linked frames: the serial reader disagrees on one segment")
    independent_total = sum(len(lt.compress_frame_parallel(seg, 65536)) for seg in segments)
    print(f"  (b) linked {linked_total:,d} B against {independent_total:,d} B for the same "
          f"segments as independent frames; serial reader equal on segment {k}")
    if linked_total > independent_total:
        fail("(b) linked frames are larger than independent frames of the same segments")

    # (c) each member as one linked frame of 4 MiB blocks, decoded in waves
    meter = PathMeter("(c) linked big blocks", ("compress", "decode_big"))
    datas = list(members.values())
    frames, t_comp = wall(lambda: [lt.compress_frame_parallel(d, 4 << 20, parallel_linked=True)
                                   for d in datas])
    back, t_dec = wall(lambda: lt.decompress_frames_parallel(frames))
    if back != datas:
        fail("(c) linked big blocks: the members do not round-trip")
    for data, frame in zip(datas, frames):
        blocks = frame_blocks(frame)
        windows = sum(65536 for k, (c, _, _) in enumerate(blocks) if c and k)
        meter.compressed(frame, len(data) + 65536 * (len(blocks) - 1))  # rows carry windows
        meter.decoded("decode_big", frame, len(data), prefix_bytes=windows)
    rates(f"(c) {len(frames)} linked frames of 4 MiB blocks, "
          f"{max(len(frame_blocks(f)) for f in frames)} waves",
          total, sum(map(len, frames)), t_comp, t_dec)
    reports["c"] = meter.finish()

    # (d) decompress_v3 through its own entry point: one member's 64 KiB blocks
    meter = PathMeter("(d) v3 entry point", ("decode_v3",))
    name = list(members)[7]
    data = members[name]
    frame = lt.compress_frame_parallel(data, 65536)
    blocks = frame_blocks(frame)
    payloads = [frame[pos : pos + n] for c, pos, n in blocks if c]
    raws = [data[i * 65536 : (i + 1) * 65536] for i, (c, _, _) in enumerate(blocks) if c]
    back, dt = wall(lambda: lt.decompress_blocks_v3(payloads, None, 65536))
    if back != raws:
        fail("(d) decompress_blocks_v3 does not return the member's blocks")
    meter.compressed(frame, len(data))
    meter.decoded("decode_v3", frame, len(data))
    print(f"  (d) {len(payloads)} blocks of {name} through decompress_blocks_v3: "
          f"{sum(map(len, raws)) / dt / 1e6:.1f} MB/s (host wall, incl. transfers)")
    reports["d"] = meter.finish()
    return reports, summaries, frames_4a, frames_4b


def phase_lane(members, scalar):
    """The lane compressor's path over the whole corpus; ``scalar`` holds the
    scalar compressor's totals on the same frame geometries (phases 3, 4a,
    4b), printed beside.  Returns one report per part."""
    import lz4tpu_torch as lt
    from lz4tpu_torch.kernels.compress import compress_blocks
    from lz4tpu_torch.kernels.compress128 import MAX_B
    from lz4tpu_torch.spec.table import U32Table

    total = sum(map(len, members.values()))
    names = list(members)
    reports = {}

    def round_trips(path, needed, block_size, decoder, scalar_path):
        """Every member as one independent lane frame of ``block_size``:
        the path's report, its frames and its summary."""
        meter = PathMeter(path, needed)
        frames = {}
        n_out = 0
        t_comp = t_dec = 0.0
        for name, data in members.items():
            frame, dt = wall(lambda: lt.compress_frame_parallel(data, block_size, lane_kernel=True))
            t_comp += dt
            back, dt = wall(lambda: lt.decompress_frame_parallel(frame))
            t_dec += dt
            if back != data:
                fail(f"{path}: {name} does not round-trip")
            sizes = [n for _, _, n in frame_blocks(frame)]
            if len(sizes) != -(-len(data) // block_size):
                fail(f"{path}: {name} has {len(sizes)} blocks, not one per {block_size} bytes")
            meter.lane_compressed(frame, len(data))
            meter.decoded(decoder, frame, len(data))
            frames[name] = frame
            n_out += len(frame)
        summary = rates(path, total, n_out, t_comp, t_dec)
        print(f"    scalar compressor, same geometry (phase {scalar_path}): {scalar[scalar_path]}")
        return meter.finish(), frames, summary

    # (a) true 4 MiB independent blocks, 128 spliced chunks each
    reports["5a"], frames_5a, summary_5a = round_trips(
        "(5a) lane, 4 MiB independent blocks", ("compress128", "decode_v4"), 4 << 20,
        "decode_v4", "4a")
    # (b) 64 KiB independent blocks, 2 spliced chunks each
    reports["5b"], _, _ = round_trips("(5b) lane, 64 KiB independent blocks",
                                      ("compress128", "decode128"), 65536, "decode128", "3")

    # (c) the 1 MiB segments as linked lane frames, decoded in waves
    segments = [data[i : i + SEGMENT] for data in members.values()
                for i in range(0, len(data), SEGMENT)]
    meter = PathMeter("(5c) lane, linked frames", ("compress128", "decode128"))
    frames, t_comp = wall(lambda: [lt.compress_frame_parallel(seg, 65536, parallel_linked=True,
                                                              lane_kernel=True)
                                   for seg in segments])
    back, t_dec = wall(lambda: lt.decompress_frames_parallel(frames))
    if back != segments:
        fail("(5c) lane, linked frames: the segments do not round-trip")
    for seg, frame in zip(segments, frames):
        blocks = frame_blocks(frame)
        windows = sum(65536 for k, (c, _, _) in enumerate(blocks) if c and k)
        meter.lane_compressed(frame, len(seg))
        meter.decoded("decode128", frame, len(seg), prefix_bytes=windows)
    linked_total = sum(map(len, frames))
    rates(f"(5c) lane, {len(segments)} linked frames of 64 KiB blocks", total, linked_total,
          t_comp, t_dec)
    print(f"    scalar compressor, same geometry (phase 4b): {scalar['4b']}")
    reports["5c"] = meter.finish()
    independent_total = sum(len(lt.compress_frame_parallel(seg, 65536, lane_kernel=True))
                            for seg in segments)
    print(f"  (5c) linked {linked_total:,d} B against {independent_total:,d} B for the same "
          f"segments as independent lane frames")
    if linked_total > independent_total:
        fail("(5c) linked lane frames are larger than independent lane frames of the same segments")

    # (d) a dictionary frame: independent at 4 MiB blocks, linked at 64 KiB
    meter = PathMeter("(5d) lane, dictionary frames", ("compress128", "decode_v4", "decode128"))
    dic = members[names[0]][-65536:]
    data = members[names[7]]
    sizes = {}
    for label, kw, decoder in (("independent, 4 MiB blocks", dict(block_size=4 << 20), "decode_v4"),
                               ("linked, 64 KiB blocks",
                                dict(block_size=65536, parallel_linked=True), "decode128")):
        frame = lt.compress_frame_parallel(data, dictionary=dic, dictionary_id=1,
                                           block_checksums=True, lane_kernel=True, **kw)
        if lt.decompress_frames_parallel([frame], dictionaries=[dic]) != [data]:
            fail(f"(5d) dictionary frame ({label}) does not round-trip")
        blocks = frame_blocks(frame)
        meter.lane_compressed(frame, len(data),
                              source_extra=len(dic) * (1 if "parallel_linked" in kw else len(blocks)))
        meter.decoded(decoder, frame, len(data), prefix_bytes=len(dic) * len(blocks))
        sizes[label] = len(frame)
        plain = len(lt.compress_frame_parallel(data, lane_kernel=True, **kw))
        print(f"  (5d) {names[7]} with a 64 KiB dictionary, {label}: ratio "
              f"{len(frame) / len(data):.4f} ({plain / len(data):.4f} without the dictionary), "
              f"round trip equal")
    reports["5d"] = meter.finish()

    # the size contract: the corpus in 32 KiB blocks, default mode against
    # the greedy compressor on the same blocks
    lane_total = greedy_total = 0
    for name, data in members.items():
        blocks = [data[i : i + MAX_B] for i in range(0, len(data), MAX_B)]
        lane = sum(map(len, lt.compress_blocks_128(blocks)))
        greedy = sum(map(len, compress_blocks(blocks, tables=[U32Table() for _ in blocks])[0]))
        lane_total += lane
        greedy_total += greedy
        print(f"    {name:8s} {len(blocks):5d} blocks: lane {lane:>11,d} B, greedy {greedy:>11,d} B "
              f"({lane / greedy:.4f})")
    print(f"  size contract, {total:,d} B in 32 KiB blocks: lane compressor {lane_total:,d} B, "
          f"greedy compressor {greedy_total:,d} B ({lane_total / greedy_total:.4f})")
    if lane_total > greedy_total:
        fail(f"the lane compressor's total {lane_total} is larger than the greedy "
             f"compressor's {greedy_total} on the same 32 KiB blocks")
    return reports, frames_5a, summary_5a


def launch_counts():
    return {name: k.launches for name, (k, _) in kernel_stats().items()}


def launched(before):
    """Launches of each kernel since ``before`` (a ``launch_counts()``)."""
    return {n: c - before[n] for n, c in launch_counts().items() if c > before[n]}


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def run_cli(part, tmp, tool, *argv) -> None:
    """``python3 -m lz4tpu_torch.cli.<tool> argv -v`` from the checkout's
    root; prints its rate line (paths shown relative to ``tmp``)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"lz4tpu_torch.cli.{tool}", *argv, "-v"],
                       cwd=HERE, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"{part} {tool} {' '.join(argv)}: exit {r.returncode}: {r.stderr[-2000:]}")
    print(f"    {tool} {' '.join(a.replace(tmp + os.sep, '') for a in argv)}: "
          f"{r.stderr.strip()} ({time.perf_counter() - t0:.1f} s with start-up)")


def read_blocks(frame, dictionary=b""):
    """A frame through the streaming reader's per-block loop (``decode_block``)."""
    import lz4tpu_torch as lt

    reader = lt.LZ4FrameReader(frame)
    parts = []
    while (block := reader.decode_block(dictionary)) is not None:
        parts.append(block)
    return b"".join(parts)


def phase_streaming(members, frames_4a):
    """The reference's own entry points on the card: (a) the default writer
    and reader (``CompressionSettings()``, ``decompress_frame``) over the
    corpus, in turns with the per-block path (a callable engine, a
    ``decode_block`` loop), frames equal to each other and to phase 4a's;
    (b) the same on one member at 64 KiB blocks with block checksums and a
    64 KiB dictionary, and ``into_read().read(n)`` in odd pieces; (c) one
    member as a linked frame (the per-block writer and reader); (d) the
    CLI as subprocesses.  Returns one report per part, and what phase 8
    holds its host engine's paths against: 6a's frames and rates, 6c's
    frame and rates."""
    import functools
    import tempfile

    import lz4tpu_torch as lt
    from lz4tpu_torch.cli import dolz4
    from lz4tpu_torch.kernels.compress import compress_block_cuda

    per_block_engine = functools.partial(compress_block_cuda, device="cuda")
    per_block = lt.CompressionSettings().engine(per_block_engine)
    names = list(members)
    total = sum(map(len, members.values()))
    reports = {}

    # (a) the default writer and reader, batched, in turns with the per-block path
    meter = PathMeter("(6a) default writer and reader", ("compress", "decode_v4"))
    secs = {(path, op): 0.0 for path in ("batched", "per block") for op in ("comp", "dec")}
    batched_frames = {}
    for i, (name, data) in enumerate(members.items()):
        frames, counts = {}, {}
        for path in (("batched", "per block") if i % 2 == 0 else ("per block", "batched")):
            before = launch_counts()
            if path == "batched":
                frame, dt = wall(lambda: lt.CompressionSettings().compress_bytes(data))
                secs[path, "comp"] += dt
                back, dt = wall(lambda: lt.decompress_frame(frame))
            else:
                frame, dt = wall(lambda: per_block.compress_bytes(data))
                secs[path, "comp"] += dt
                back, dt = wall(lambda: read_blocks(frame))
            secs[path, "dec"] += dt
            counts[path] = launched(before)
            frames[path] = frame
            if back != data:
                fail(f"(6a) {path}: {name} does not round-trip")
            meter.compressed(frame, len(data), kernel=frame_kernel(data)
                             if path == "batched" else "compress")
            meter.decoded("decode_v4", frame, len(data))
        if not frames["batched"] == frames["per block"] == frames_4a[name]:
            fail(f"(6a) {name}: the batched, per-block and phase 4a frames differ")
        _, _, nc, ns = frame_stats(frames["batched"])
        kernel = frame_kernel(data)
        want = {kernel: 1, "decode_v4": 1} if nc else {kernel: 1}
        if counts["batched"] != want:
            fail(f"(6a) {name}: the batched path launched {counts['batched']}, not {want}")
        batched_frames[name] = frames["batched"]
        print(f"    {name:8s} {nc + ns:3d} blocks; batched launches {counts['batched']}, "
              f"per block {counts['per block']}")
    n_out = sum(map(len, batched_frames.values()))
    summary_6a = {path: rates(f"(6a) 4 MiB independent blocks, {path}", total, n_out,
                              secs[path, "comp"], secs[path, "dec"])
                  for path in ("batched", "per block")}
    print("  (6a) batched and per-block frames equal to each other and to phase 4a's")
    reports["6a"] = meter.finish()

    # (b) one member at 64 KiB blocks, block checksums, a 64 KiB dictionary
    meter = PathMeter("(6b) 64 KiB blocks, dictionary", ("compress", "decode128", "decode_v4"))
    dic = members[names[0]][-65536:]
    name = names[7]
    data = members[name]

    def settings():
        return lt.CompressionSettings().block_size(65536).block_checksums(True).dictionary(1, dic)

    frame, t_comp = wall(lambda: settings().compress_bytes(data))
    back, t_dec = wall(lambda: lt.decompress_frame(frame, dictionary=dic))
    serial, t_comp_serial = wall(lambda: settings().engine(per_block_engine).compress_bytes(data))
    back_serial, t_dec_serial = wall(lambda: read_blocks(frame, dic))
    whole = lt.compress_frame_parallel(data, 65536, dictionary=dic, dictionary_id=1,
                                       block_checksums=True)
    if not frame == serial == whole:
        fail(f"(6b) {name}: the batched, per-block and compress_frame_parallel frames differ")
    if not back == back_serial == data:
        fail(f"(6b) {name}: the dictionary frame does not round-trip")
    pieces = []
    io_reader = lt.LZ4FrameReader(frame).into_read(dic)
    sizes = (1, 7, 4093, 65537, 100003, 13)
    while piece := io_reader.read(sizes[len(pieces) % len(sizes)]):
        pieces.append(piece)
    if b"".join(pieces) != data:
        fail(f"(6b) {name}: into_read().read(n) in odd pieces does not give the member")
    nblocks = len(frame_blocks(frame))
    for _ in range(2):
        meter.compressed(frame, len(data), row_extra=len(dic))
    meter.decoded("decode128", frame, len(data), prefix_bytes=len(dic) * nblocks)
    for _ in range(2):
        meter.decoded("decode_v4", frame, len(data), prefix_bytes=len(dic) * nblocks)
    mb = len(data) / 1e6
    print(f"  (6b) {name}, {nblocks} blocks of 64 KiB behind a 64 KiB dictionary: batched "
          f"compress {mb / t_comp:.1f} MB/s, decompress {mb / t_dec:.1f} MB/s; per block "
          f"compress {mb / t_comp_serial:.1f} MB/s, decompress {mb / t_dec_serial:.1f} MB/s; "
          f"frames equal; into_read in {len(pieces)} pieces equal")
    reports["6b"] = meter.finish()

    # (c) one member as a linked frame of 4 MiB blocks: the per-block writer and reader
    meter = PathMeter("(6c) linked frame, per block", ("compress", "decode_big"))
    name = names[0]
    data = members[name]
    frame, t_comp = wall(lambda: lt.CompressionSettings().independent_blocks(False)
                         .compress_bytes(data))
    back, t_dec = wall(lambda: lt.decompress_frame(frame))
    if back != data:
        fail(f"(6c) {name}: the linked frame does not round-trip")
    if len(frame) > len(batched_frames[name]):
        fail(f"(6c) {name}: the linked frame is larger than the independent one")
    blocks = frame_blocks(frame)
    meter.compressed(frame, len(data) + 65536 * (len(blocks) - 1))  # rows carry windows
    meter.decoded("decode_big", frame, len(data),
                  prefix_bytes=sum(65536 for k, (c, _, _) in enumerate(blocks) if c and k))
    summary_6c = rates(f"(6c) {name} as one linked frame of {len(blocks)} blocks of 4 MiB",
                       len(data), len(frame), t_comp, t_dec)
    reports["6c"] = meter.finish()
    mirror = {"6a": batched_frames, "6a rates": summary_6a["batched"], "6c": frame,
              "6c rates": summary_6c}

    # (d) the CLI as subprocesses on the card, one member in a temporary directory
    meter = PathMeter("(6d) CLI", ("compress128", "compress"))
    name = names[-1]
    data = members[name]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, name)
        with open(src, "wb") as f:
            f.write(data)
        head = os.path.join(tmp, "head")
        with open(head, "wb") as f:
            f.write(data[: 256 << 10])

        def cli(tool, *argv):
            run_cli("(6d)", tmp, tool, *argv)

        cases = (("cuda", src, [], batched_frames[name]),
                 ("cuda-parallel", src, [], frames_4a[name]),
                 ("cuda-parallel", src, ["--lane-kernel"], None),
                 ("cuda", head, ["--level", "9"], None))
        for engine, path, extra, want in cases:
            out = os.path.join(tmp, f"{engine}{''.join(extra)}.lz4")
            cli("dolz4", path, out, "--engine", engine, *extra)
            cli("delz4", out, out + ".back", "--engine", engine)
            if read(out + ".back") != read(path):
                fail(f"(6d) dolz4/delz4 --engine {engine} {extra}: the output differs from the input")
            if want is not None and read(out) != want:
                fail(f"(6d) dolz4 --engine {engine}: the frame differs from phase 6a's")
            if extra == ["--lane-kernel"]:
                # in process too, so that this process counts the lane kernel's launch
                dolz4.main([path, out + ".here", "--engine", engine, *extra])
                if read(out + ".here") != read(out):
                    fail("(6d) dolz4 --lane-kernel: the frame made here differs from the "
                         "subprocess's")
                meter.lane_compressed(read(out), len(data))
            if extra[:1] == ["--level"]:
                greedy = lt.CompressionSettings().compress_bytes(data[: 256 << 10])
                meter.compressed(greedy, 256 << 10)
                print(f"    --level 9 on {256 << 10} B: {len(read(out)):,d} B against "
                      f"{len(greedy):,d} B greedy")
                if len(read(out)) > len(greedy):
                    fail("(6d) dolz4 --level 9 made a larger frame than the greedy parse")
    print(f"  (6d) dolz4/delz4 on {name} ({len(data):,d} B): engines cuda, cuda-parallel, "
          f"cuda-parallel --lane-kernel and --level 9 round-trip; scalar frames equal to 6a's")
    reports["6d"] = meter.finish()
    return reports, mirror


RUNNER_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
import lz4tpu_torch as lt
rank, world = lt.initialize_distributed(sys.argv[2], 2, int(sys.argv[3]))
stats = lt.run_sharded_compress(
    sys.argv[4], sys.argv[5], shard_bytes=int(sys.argv[6]), block_size=65536,
    process_index=rank, process_count=world, mesh=lt.make_mesh(devices=["cuda:0"]),
    workdir=sys.argv[7], finalize=False)
dist.barrier()
dist.destroy_process_group()
print("WORKER", rank, stats["compressed_here"], flush=True)
"""


def phase_mesh(members, frames, summaries):
    """Slice 8's path over the whole corpus: (7a) phase 3's geometry on a
    mesh of every card and on four entries of ``cuda:0``, decoded on both
    and once on decompress_v4; (7b) phase 4b's linked segments on the
    four-entry mesh, decoded by one ``decompress_frames_parallel``; (7c)
    phase 5a's lane frames on the four-entry mesh, no block split between
    entries; (7d) the runner: a file of the corpus in 16 MiB shards,
    resumed after three shards are deleted, decoded, and again by two
    processes on ``cuda:0``.  Frames must equal the phases' they mirror
    (``frames``), and the launches of a call the mesh entries that get
    work; MB/s are printed beside the mirrored phase's (``summaries``).
    Returns one report per part."""
    import shutil
    import socket
    import tempfile

    import torch

    import lz4tpu_torch as lt
    from lz4tpu_torch.kernels.compress128 import MAX_B
    from lz4tpu_torch.parallel import blocks as block_work
    from lz4tpu_torch.parallel.mesh import shard_bounds

    total = sum(map(len, members.values()))
    n_cards = torch.cuda.device_count()
    four = lt.make_mesh(devices=["cuda:0"] * 4)
    meshes = {f"every card ({n_cards})": lt.make_mesh(), "cuda:0 x4": four}
    if n_cards > 1:
        meshes.update({f"{k} cards": lt.make_mesh(k) for k in range(2, n_cards)})
    reports = {}

    def check_launches(part, got, want):
        want = {k: v for k, v in want.items() if v}
        if got != want:
            fail(f"{part}: launches {got}, not one a mesh entry with work: {want}")

    # (a) 64 KiB independent blocks, phase 3's geometry
    print(f"  phase 3's geometry, same run: {summaries['3']}")
    for label, mesh in meshes.items():
        part = f"(7a) 64 KiB independent blocks, mesh {label}"
        meter = PathMeter(part, ("compress", "decode128"))
        t_comp = t_dec = 0.0
        for name, data in members.items():
            before = launch_counts()
            frame, dt = wall(lambda: lt.compress_frame_parallel(data, 65536, content_checksum=True,
                                                                mesh=mesh))
            t_comp += dt
            if frame != frames["3"][name]:
                fail(f"{part}: {name}'s frame differs from phase 3's")
            _, _, nc, ns = frame_stats(frame)
            check_launches(f"{part}, {name} compress", launched(before),
                           {"compress": min(nc + ns, mesh.size)})
            before = launch_counts()
            back, dt = wall(lambda: lt.decompress_frame_parallel(frame, mesh=mesh))
            t_dec += dt
            if back != data:
                fail(f"{part}: {name} does not round-trip")
            check_launches(f"{part}, {name} decompress", launched(before),
                           {"decode128": min(nc, mesh.size)})
            meter.compressed(frame, len(data))
            meter.decoded("decode128", frame, len(data))
        rates(part, total, sum(map(len, frames["3"].values())), t_comp, t_dec)
        reports[f"7a {label}"] = meter.finish()
    part = "(7a) decompress_v4 (lane_kernel=False), mesh cuda:0 x4"
    meter = PathMeter(part, ("decode_v4",))
    t_dec = 0.0
    for name, data in members.items():
        frame = frames["3"][name]
        back, dt = wall(lambda: lt.decompress_frame_parallel(frame, mesh=four, lane_kernel=False))
        t_dec += dt
        if back != data:
            fail(f"{part}: {name} does not round-trip")
        meter.decoded("decode_v4", frame, len(data))
    print(f"  {part}: decompress {total / t_dec / 1e6:.1f} MB/s (host wall, incl. transfers)")
    reports["7a v4"] = meter.finish()

    # (b) phase 4b's 1 MiB segments as parallel_linked frames on four entries
    segments = [data[i : i + SEGMENT] for data in members.values()
                for i in range(0, len(data), SEGMENT)]
    part = "(7b) linked frames of 64 KiB blocks, mesh cuda:0 x4"
    meter = PathMeter(part, ("compress", "decode128"))
    before = launch_counts()
    made, t_comp = wall(lambda: [lt.compress_frame_parallel(seg, 65536, parallel_linked=True,
                                                            mesh=four) for seg in segments])
    check_launches(f"{part} compress", launched(before), {"compress": sum(
        min(len(frame_blocks(f)), 4) for f in made)})
    if made != frames["4b"]:
        fail(f"{part}: the frames differ from phase 4b's")
    back, t_dec = wall(lambda: lt.decompress_frames_parallel(made, mesh=four))
    if back != segments:
        fail(f"{part}: the segments do not round-trip")
    for seg, frame in zip(segments, made):
        blocks = frame_blocks(frame)
        windows = sum(65536 for k, (c, _, _) in enumerate(blocks) if c and k)
        meter.compressed(frame, len(seg) + 65536 * (len(blocks) - 1))  # rows carry windows
        meter.decoded("decode128", frame, len(seg), prefix_bytes=windows)
    rates(f"{part}, {len(segments)} frames", total, sum(map(len, made)), t_comp, t_dec)
    print(f"    phase 4b, same run: {summaries['4b']}")
    reports["7b"] = meter.finish()

    # (c) phase 5a's lane frames of 4 MiB blocks on four entries; each
    # launch's chunks are whole blocks' (a spy on the wrapper, which counts)
    part = "(7c) lane, 4 MiB independent blocks, mesh cuda:0 x4"
    meter = PathMeter(part, ("compress128", "decode_v4"))
    rows = []
    real = block_work.compress128

    def spy(src, base, *args, **kw):
        rows.append(int(base.shape[0]))
        return real(src, base, *args, **kw)

    t_comp = t_dec = 0.0
    block_work.compress128 = spy
    try:
        for name, data in members.items():
            del rows[:]
            frame, dt = wall(lambda: lt.compress_frame_parallel(data, 4 << 20, lane_kernel=True,
                                                                mesh=four))
            t_comp += dt
            if frame != frames["5a"][name]:
                fail(f"{part}: {name}'s frame differs from phase 5a's")
            lens = [min(4 << 20, len(data) - i) for i in range(0, len(data), 4 << 20)]
            want = [sum(-(-n // MAX_B) for n in lens[lo:hi])
                    for lo, hi in shard_bounds(len(lens), 4) if hi > lo]
            if rows != want:
                fail(f"{part}: {name}'s launches took {rows} chunks, not whole blocks' {want}")
            back, dt = wall(lambda: lt.decompress_frame_parallel(frame, mesh=four))
            t_dec += dt
            if back != data:
                fail(f"{part}: {name} does not round-trip")
            meter.lane_compressed(frame, len(data))
            meter.decoded("decode_v4", frame, len(data))
    finally:
        block_work.compress128 = real
    rates(part, total, sum(map(len, frames["5a"].values())), t_comp, t_dec)
    print(f"    phase 5a, same run: {summaries['5a']}")
    reports["7c"] = meter.finish()

    # (d) the runner: the corpus as one file in 16 MiB shards of 64 KiB blocks
    part = f"(7d) runner, {RUNNER_SHARD:,d}-byte shards of 64 KiB blocks"
    meter = PathMeter(part, ("compress", "decode128"))
    shard = RUNNER_SHARD
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runner_")
    procs = []
    try:
        src = os.path.join(tmp, "corpus.bin")
        with open(src, "wb") as f:
            for data in members.values():
                f.write(data)
        with open(src, "rb") as f:
            whole = f.read()
        out = os.path.join(tmp, "corpus.lz4")
        cards = lt.make_mesh().size
        before = launch_counts()
        stats, t_comp = wall(lambda: lt.run_sharded_compress(src, out, shard_bytes=shard))
        comp_launches = launched(before)
        with open(out, "rb") as f:
            archive = f.read()
        n_shards = stats["n_shards"]
        if stats["compressed_here"] != n_shards or not stats.get("finalized"):
            fail(f"{part}: first run {stats}")
        shard_frames = []
        for k in range(n_shards):
            with open(os.path.join(out + ".shards", f"shard-{k:07d}.lz4"), "rb") as f:
                shard_frames.append(f.read())
        check_launches(f"{part} compress", comp_launches, {"compress": sum(
            min(len(frame_blocks(f)), cards) for f in shard_frames)})
        # resume: three shard files and the archive deleted, only they are redone
        gone = min(3, n_shards)
        deleted = list(range(0, n_shards, max(n_shards // gone, 1)))[:gone]
        for k in deleted:
            os.unlink(os.path.join(out + ".shards", f"shard-{k:07d}.lz4"))
        os.unlink(out)
        stats2, t_resume = wall(lambda: lt.run_sharded_compress(src, out, shard_bytes=shard))
        if (stats2["compressed_here"], stats2["skipped"]) != (gone, n_shards - gone):
            fail(f"{part}: the resumed run {stats2}, not {gone} compressed and "
                 f"{n_shards - gone} skipped")
        with open(out, "rb") as f:
            if f.read() != archive:
                fail(f"{part}: the resumed archive differs")
        back = os.path.join(tmp, "corpus.back")
        before = launch_counts()
        _, t_dec = wall(lambda: lt.run_sharded_decompress(out, back))
        check_launches(f"{part} decompress", launched(before), {"decode128": sum(
            min(frame_stats(f)[2], cards) for f in shard_frames)})
        with open(back, "rb") as f:
            if f.read() != whole:
                fail(f"{part}: the archive does not decode to the corpus")
        for k, frame in enumerate(shard_frames):
            piece = len(whole[k * shard : (k + 1) * shard])
            for _ in range(2 if k in deleted else 1):
                meter.compressed(frame, piece)
            meter.decoded("decode128", frame, piece)
        rates(f"{part}, {n_shards} shards, mesh every card", total, len(archive), t_comp, t_dec)
        print(f"    resumed: {gone} shards again, {n_shards - gone} skipped, "
              f"{t_resume:.2f} s; archive byte-equal")
        print(f"    phase 3, same run: {summaries['3']}")
        reports["7d"] = meter.finish()

        # two processes on cuda:0, meeting through gloo, claiming alternate shards
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out2 = os.path.join(tmp, "two.lz4")
        work2 = os.path.join(tmp, "two.shards")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", RUNNER_WORKER, HERE, f"localhost:{port}", str(rank), src, out2,
             str(shard), work2], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for rank, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"WORKER {rank}" not in text:
                fail(f"(7d) runner process {rank}: exit {p.returncode}: {text[-2000:]}")
        claims = [int(text.split("WORKER")[1].split()[1]) for text in outs]
        t_two = time.perf_counter() - t0
        stats3 = lt.run_sharded_compress(src, out2, shard_bytes=shard, workdir=work2)
        with open(out2, "rb") as f:
            if not stats3.get("finalized") or f.read() != archive:
                fail("(7d) the two processes' archive differs from the single process's")
        if claims != [-(-n_shards // 2), n_shards // 2]:
            fail(f"(7d) the two processes claimed {claims} of {n_shards} shards")
        print(f"  (7d) two processes on cuda:0 (gloo rendezvous): shards {claims[0]} and "
              f"{claims[1]}, {t_two:.1f} s with start-up; the parent joined them, archive "
              f"byte-equal to the single process's")
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return reports


def host_cpu() -> str:
    """The host's CPU (the first processor's vendor, family, model, model
    name and clock, as /proc/cpuinfo gives them) and count, printed beside
    every host rate."""
    keys = ("vendor_id", "cpu family", "model", "model name", "cpu MHz")
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not line.strip():
                    break
                if key.strip() in keys:
                    found[key.strip()] = value.strip()
    except OSError:
        pass
    desc = ", ".join(f"{k} {found[k]}" for k in keys if k in found) or "no /proc/cpuinfo"
    return f"{desc}; os.cpu_count() {os.cpu_count()}"


def phase_native(members, frames_4a, mirror, smi):
    """The host engine on the card's machine: (8a) ``level(9)`` at 4 MiB
    independent blocks over dickens on ``"cuda"`` (greedy payloads from
    compress.cu, the native HC parse) and on ``"native"``: frames equal, no
    larger than 4a's, read back on ``"cuda"`` (decompress_v4); the native HC
    parse beside ``spec.hc`` on a 256 KiB head; (8b) the default writer and
    reader over the corpus on ``"native"`` with ``threads(1)`` and
    ``threads(0)``, frames equal to 6a's; (8c) 6c's linked frame on
    ``"native"``; (8d) ``dolz4``/``delz4 --engine native``.  Host rates,
    printed beside the same run's device rates (``mirror``: phase 6's
    frames and rates).  The native paths must launch no kernel.  Returns
    8a's report."""
    import shutil
    import tempfile

    import lz4tpu_torch as lt
    from lz4tpu_torch import native
    from lz4tpu_torch.spec.hc import compress_block_hc as spec_compress_block_hc

    print(f"  host rates on {host_cpu()}; card {smi}")
    names = list(members)
    total = sum(map(len, members.values()))

    def native_only(part, fn):
        before = launch_counts()
        res = wall(fn)
        if launched(before):
            fail(f"{part}: the native engine launched {launched(before)}")
        return res

    # (a) level 9 at 4 MiB independent blocks, on "cuda" and on "native"
    name = names[0]
    data = members[name]
    meter = PathMeter(f"(8a) level 9, {name}, cuda", ("compress", "decode_v4"))
    frame_cuda, t_cuda = wall(lambda: lt.CompressionSettings().level(9).compress_bytes(data))
    # compress.cu made 4a's greedy payloads
    meter.compressed(frames_4a[name], len(data), kernel=frame_kernel(data))
    back = lt.decompress_frame(frame_cuda)
    frame_native, t_native = native_only("(8a)", lambda: lt.CompressionSettings().engine(
        "native").level(9).compress_bytes(data))
    back_native = lt.decompress_frame(frame_native)
    for frame in (frame_cuda, frame_native):
        meter.decoded("decode_v4", frame, len(data))
    report = meter.finish()
    if frame_cuda != frame_native:
        fail(f"(8a) {name}: the level-9 frames of cuda and native differ")
    if len(frame_cuda) > len(frames_4a[name]):
        fail(f"(8a) {name}: the level-9 frame is larger than 4a's greedy frame")
    if not back == back_native == data:
        fail(f"(8a) {name}: the level-9 frames do not read back on cuda")
    blocks = [data[i : i + (4 << 20)] for i in range(0, len(data), 4 << 20)]
    _, t_hc = wall(lambda: [native.compress_block_hc(b, level=9) for b in blocks])
    head = data[: 256 << 10]
    hc_native, t_head = wall(lambda: native.compress_block_hc(head, level=9))
    hc_spec, t_head_spec = wall(lambda: spec_compress_block_hc(head, level=9))
    if hc_native != hc_spec:
        fail("(8a) the native and spec.hc level-9 parses of the head differ")
    mb = len(data) / 1e6
    print(f"  (8a) {name} at level 9, {len(blocks)} blocks of 4 MiB: {len(frame_cuda):,d} B "
          f"against 4a's greedy {len(frames_4a[name]):,d} B; writer on cuda {mb / t_cuda:.1f} "
          f"MB/s, on native {mb / t_native:.1f} MB/s; frames equal, read back on cuda")
    print(f"  (8a) the HC parse alone: native {mb / t_hc:.2f} MB/s over {name}'s blocks, one "
          f"thread; on a {len(head):,d} B head native {len(head) / t_head / 1e6:.2f} MB/s, "
          f"spec.hc (the Python parse that level() ran before) "
          f"{len(head) / t_head_spec / 1e6:.3f} MB/s; equal")

    # (b) the default writer and reader over the corpus, threads(1) and threads(0)
    saved = os.environ.get("LZ4TPU_HOST_THREADS")
    try:
        for threads in (1, 0):
            if threads:
                os.environ["LZ4TPU_HOST_THREADS"] = str(threads)
            else:
                os.environ.pop("LZ4TPU_HOST_THREADS", None)
            settings = lt.CompressionSettings().engine("native").threads(threads)
            t_comp = t_dec = 0.0
            n_out = 0
            for name, data in members.items():
                frame, dt = native_only("(8b)", lambda: settings.compress_bytes(data))
                t_comp += dt
                if frame != mirror["6a"][name]:
                    fail(f"(8b) threads({threads}): {name}'s frame differs from 6a's")
                back, dt = native_only("(8b)", lambda: lt.decompress_frame(frame,
                                                                           engine="native"))
                t_dec += dt
                if back != data:
                    fail(f"(8b) threads({threads}): {name} does not round-trip")
                n_out += len(frame)
            rates(f"(8b) 4 MiB independent blocks, native, threads({threads}) "
                  f"({native.host_threads(threads)} threads)", total, n_out,
                  t_comp, t_dec)
    finally:
        if saved is None:
            os.environ.pop("LZ4TPU_HOST_THREADS", None)
        else:
            os.environ["LZ4TPU_HOST_THREADS"] = saved
    print(f"    6a, batched on cuda, same run: {mirror['6a rates']}; frames equal to 6a's")

    # (c) 6c's linked frame on native
    name = names[0]
    data = members[name]
    frame, t_comp = native_only("(8c)", lambda: lt.CompressionSettings().engine("native")
                                .independent_blocks(False).compress_bytes(data))
    if frame != mirror["6c"]:
        fail(f"(8c) {name}: the linked frame differs from 6c's")
    back, t_dec = native_only("(8c)", lambda: lt.decompress_frame(frame, engine="native"))
    if back != data:
        fail(f"(8c) {name}: the linked frame does not round-trip")
    rates(f"(8c) {name} as one linked frame, native", len(data), len(frame), t_comp, t_dec)
    print(f"    6c, per block on cuda, same run: {mirror['6c rates']}; frame equal to 6c's")

    # (d) the CLI on native, as subprocesses; compared with cmp
    name = names[-1]
    data = members[name]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    try:
        src = os.path.join(tmp, name)
        with open(src, "wb") as f:
            f.write(data)
        out = os.path.join(tmp, "native.lz4")
        run_cli("(8d)", tmp, "dolz4", src, out, "--engine", "native")
        run_cli("(8d)", tmp, "delz4", out, out + ".back", "--engine", "native")
        cmp = shutil.which("cmp")
        if not (subprocess.run([cmp, "-s", src, out + ".back"]).returncode == 0 if cmp
                else read(src) == read(out + ".back")):
            fail("(8d) dolz4/delz4 --engine native: the output differs from the input")
        if read(out) != mirror["6a"][name]:
            fail("(8d) dolz4 --engine native: the frame differs from 6a's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  (8d) dolz4/delz4 --engine native on {name} ({len(data):,d} B) round-trip "
          f"({'cmp' if cmp else 'compared in Python: no cmp'}); the frame equal to 6a's")
    return {"8a": report}


def f1_frame(n_blocks: int, bd: int, linked: bool = False, first: int = 0):
    """(frame, content): a frame with a content checksum (independent, or
    linked) of ``n_blocks`` compressed blocks of one byte each, block i the
    2-byte stream ``10 b`` with ``b = (7 (first + i)) & 0xFF``: what a
    streaming writer that flushes after every byte makes.  BD ``0x70``
    declares 4 MiB blocks, ``0x40`` 64 KiB."""
    import numpy as np

    from lz4tpu_torch import native

    flg = 0x44 if linked else 0x64
    content = ((np.arange(first, first + n_blocks) * 7) & 0xFF).astype(np.uint8)
    body = np.zeros((n_blocks, 6), np.uint8)
    body[:, 0] = 2
    body[:, 4] = 0x10
    body[:, 5] = content
    content = content.tobytes()
    header = bytes([0x04, 0x22, 0x4D, 0x18, flg, bd, (native.xxh32(bytes([flg, bd])) >> 8) & 0xFF])
    return header + body.tobytes() + bytes(4) + native.xxh32(content).to_bytes(4, "little"), content


def phase_f1(smi):
    """Slice 10's bound on the card: frames of one-byte blocks far below
    their block maxsize decode in groups under ``DECODE_BUDGET``.  (a) 25,000
    blocks under a 4 MiB maxsize (more than 80 GB of output rows as one
    launch) and (b) 200,000 under 64 KiB, each through ``read_all`` on
    ``"cuda"``, ``decompress_frame_parallel`` (and ``lane_kernel=False``),
    ``decompress_frames_parallel`` (both frames in one call) and ``read_all``
    on ``"native"``; (c) 25,000 one-block linked frames of 4 MiB maxsize in
    one ``decompress_frames_parallel`` call, one wave.  Each call's bytes
    equal the content built here; its peak device memory (above what was
    allocated before it) must stay under the budget + the packed
    compressed rows + the content + 256 MiB, plus 64 KiB a linked frame for
    the windows and, on decompress_v4, its scratch (``SCRATCH_BUDGET`` of
    ``csrc/decode_v4.cu``, at the group's shape): the default route takes
    the 4 MiB frame to decompress_v4 too."""
    import torch

    import lz4tpu_torch as lt
    from lz4tpu_torch import build
    from lz4tpu_torch.kernels.pack import DECODE_BUDGET, budget_groups
    from lz4tpu_torch.runtime import round_up

    from lz4tpu_torch.parallel.blocks import PIPELINE_DEPTH

    mib = 1 << 20
    print(f"  card {smi}; DECODE_BUDGET {DECODE_BUDGET / mib:,.0f} MiB a device; "
          f"PIPELINE_DEPTH {PIPELINE_DEPTH}")
    if PIPELINE_DEPTH < 2:
        fail("(9) the budget's bound is to hold with groups dispatched ahead (depth > 1)")
    launches = {}
    frames = {name: f1_frame(F1_BLOCKS[name], bd) for name, bd in (("4 MiB", 0x70),
                                                                      ("64 KiB", 0x40))}
    maxsize = {"4 MiB": 4 * mib, "64 KiB": 64 << 10}
    rows = {name: len(content) * 16 for name, (_, content) in frames.items()}

    def measured(label, fn, want, bound, needed=()):
        meter = PathMeter(f"(9) {label}", needed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, t = wall(fn)
        peak = torch.cuda.max_memory_allocated() - base
        report = meter.finish()
        if got != want:
            fail(f"(9) {label}: the output differs from the content")
        groups = {n: r["launches"] for n, r in report.items() if r["launches"]}
        for n, k in groups.items():
            launches[n] = launches.get(n, 0) + k
        if not needed and groups:
            fail(f"(9) {label}: the native engine launched {groups}")
        print(f"    peak {peak / mib:,.1f} MiB of a bound of {bound / mib:,.1f} MiB; launches "
              f"{groups or 'none'}; {t:.2f} s")
        if peak > bound:
            fail(f"(9) {label}: peak device memory {peak:,d} B over the bound {bound:,d} B")

    v4_scratch = {}  # the default route's decompress_v4 scratch, by maxsize
    for part, (name, (frame, content)) in zip("ab", frames.items()):
        n = len(content)
        kernel = "decode_v4" if maxsize[name] > 64 << 10 else "decode128"
        out_capacity = round_up(maxsize[name] + 16, 16)
        bound = DECODE_BUDGET + rows[name] + n + 256 * mib
        group = budget_groups(n, out_capacity + 16)[0][1]
        scratch = build.load().lz4t_decode_v4_scratch(group, 16, out_capacity)
        v4_scratch[name] = scratch if kernel == "decode_v4" else 0
        default = bound + v4_scratch[name]
        print(f"  ({part}) {n:,d} blocks of one byte, {name} maxsize, {len(frame):,d} B of "
              f"frame: {n * (out_capacity + 16) / 1e9:,.1f} GB of output rows as one launch")
        measured(f"read_all cuda, {name}", lambda: lt.LZ4FrameReader(frame).read_all(),
                 content, default, (kernel,))
        measured(f"decompress_frame_parallel, {name}",
                 lambda: lt.decompress_frame_parallel(frame), content, default, (kernel,))
        measured(f"decompress_frame_parallel(lane_kernel=False), {name}",
                 lambda: lt.decompress_frame_parallel(frame, lane_kernel=False), content,
                 bound + scratch, ("decode_v4",))
        measured(f"read_all native, {name}",
                 lambda: lt.decompress_frame(frame, engine="native"), content, 256 * mib)
    both = [content for _, content in frames.values()]
    measured("decompress_frames_parallel, both frames",
             lambda: lt.decompress_frames_parallel([f for f, _ in frames.values()]), both,
             DECODE_BUDGET + sum(rows.values()) + sum(map(len, both)) + 256 * mib
             + max(v4_scratch.values()), ("decode_v4", "decode128"))
    linked = [f1_frame(1, 0x70, linked=True, first=j) for j in range(F1_LINKED)]
    print(f"  (c) {len(linked):,d} one-block linked frames of 4 MiB maxsize, one wave")
    measured("decompress_frames_parallel, linked",
             lambda: lt.decompress_frames_parallel([f for f, _ in linked]),
             [c for _, c in linked],
             DECODE_BUDGET + len(linked) * (16 + 1 + (64 << 10)) + 256 * mib, ("decode_big",))
    return launches


def phase_bench_and_entry(scale: float):
    """Slice 11's programs on the card: (a) the bench as a subprocess, its
    line checked; (b) ``entry()``'s step against its payloads and its plain
    version; (c) ``dryrun_multichip`` on every card and on four entries of
    ``cuda:0``.  Returns the report of (b) and (c), whose launches are this
    process's."""
    import torch

    from lz4tpu_torch import bench, entry

    torch.cuda.empty_cache()  # the bench process allocates on the same card
    env = dict(os.environ)
    if scale < 1:
        env.update(LZ4TPU_BENCH_SIL_SCALE=str(scale),
                   LZ4TPU_BENCH_DBIG_MB_1M=str(max(128 * scale, 1)),
                   LZ4TPU_BENCH_DBIG_MB_4M=str(max(512 * scale, 4)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lz4tpu_torch.bench"], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=600)
    t = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        print("    " + line)
    if r.returncode != 0:
        fail(f"(10a) the bench exited {r.returncode}: {r.stderr[-3000:]}")
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"(10a) the bench's last line is not a JSON object: {lines[-1:]}")
    print(f"  (10a) bench line ({t:.1f} s with start-up): {lines[-1]}")
    extra = result.get("extra", {})
    missing = [k for k in bench.KEYS if k not in extra]
    errors = [k for k in extra if k.endswith("_error")]
    idle = [k for k, n in extra.get("launches", {}).items() if n <= 0]
    if result.get("metric") != "cuda_decode_gbps_per_card_silesia" or not result.get("value", 0) > 0:
        fail(f"(10a) the bench's headline is {result.get('metric')} = {result.get('value')}")
    if result["vs_baseline"] != round(result["value"] / bench.BASELINE_DECODE_GBPS, 4):
        fail(f"(10a) vs_baseline {result['vs_baseline']} is not value / 4.5")
    if missing or errors or idle or len(extra.get("launches", {})) != 6:
        fail(f"(10a) the bench's line lacks {missing}, has {errors}, launched no {idle}")
    if extra["cuda_compress128_strict_parity"] != "128/128 (32 KiB blocks)":
        fail(f"(10a) STRICT parity {extra['cuda_compress128_strict_parity']}")
    print(f"  (10a) the bench's launches: {extra['launches']}")

    meter = PathMeter("(10b, c) entry() and dryrun_multichip", ("decode128", "compress",
                                                                 "decode_v4"))
    fn, args = entry.entry()
    out, out_len, status = fn(*args)
    want = entry.example_payloads()
    out_len = out_len.cpu().tolist()
    got = [out[i, : out_len[i]].cpu().numpy().tobytes() for i in range(len(want))]
    if status.cpu().tolist() != [0] * len(want) or got != want:
        fail("(10b) entry()'s step does not decode its example batch to its payloads")
    same("(10b) entry() against its plain version", (out, torch.tensor(out_len), status),
         fn(*(a.cpu() for a in args)), labels=("out", "out_len", "status"))
    meter.traffic["decode128"] += int(args[1].sum()) + sum(map(len, want))
    print(f"  (10b) entry(): decode128 over {len(want)} blocks, every status 0, the payloads "
          "and the plain version's tensors equal")
    for n_devices, devices in ((torch.cuda.device_count(), None), (4, ["cuda:0"] * 4)):
        frames = entry.dryrun_multichip(n_devices, devices=devices)
        data = entry.dryrun_data(n_devices)
        meter.compressed(frames["independent"], len(data))
        meter.decoded("decode128", frames["independent"], len(data))
        meter.compressed(frames["linked"], len(data), row_extra=65536)
        meter.decoded("decode_v4", frames["linked"], len(data))
        per = len(data) // n_devices
        for f in frames["frames"]:
            meter.compressed(f, per, row_extra=65536)
            meter.decoded("decode128", f, per)
    return {"10": meter.finish()}


def trace_call(label, fn, path):
    """One warm call of ``fn`` under torch.profiler: from its Chrome trace,
    each memcpy kind's copies, bytes and largest copy and the device time
    of each kind of event, and the share of the call's wall in which the
    card was busy (the union of its device intervals: the copy stream and
    the kernels' stream overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans, copies, kinds = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        kinds[e["cat"]] = kinds.get(e["cat"], 0.0) + float(e["dur"]) / 1e3
        if e["cat"] == "gpu_memcpy":
            nbytes = e.get("args", {}).get("bytes")
            if nbytes is None:
                fail(f"(11) {label}: the trace gives no size of a copy ({e['name']})")
            c = copies.setdefault(e["name"], {"copies": 0, "bytes": 0, "largest": 0, "ms": 0.0})
            c["copies"] += 1
            c["bytes"] += int(nbytes)
            c["largest"] = max(c["largest"], int(nbytes))
            c["ms"] += float(e["dur"]) / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    print(f"  {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), device time by kind "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(kinds.items())))
    for name, c in sorted(copies.items()):
        print(f"    {name}: {c['copies']} copies, {c['bytes']:,d} B, largest {c['largest']:,d} B, "
              f"{c['ms']:.2f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "copies": copies}


def phase_transport(members, frames_3, paths, launches_9, scale: float):
    """Slice 12's transport on the card (``lz4tpu_torch/hostpack.py`` and the
    pipelined units of ``parallel/blocks.py``): (a) staging reuse: a
    fetched result held while later fetches and decodes take buffers keeps
    its bytes, and a buffer let go is taken again; (b) a frame decoded on
    one device and on three entries of ``cuda:0``, linked frames in waves
    and the batched writer in 2 MiB batches, units dispatched ahead, at the
    budget and with it shrunk to many groups, each run twice against the
    content or the one-launch frame (a race between the copy stream and the
    kernels' would show as other bytes now and then); (c) the device trace of phase 3's mozilla
    decompress and of 5a's compress of mozilla: no frame path copies more
    than ``PAGEABLE_MAX`` bytes through pageable memory; (d) the launches of
    phases 3-8 and 9 beside B3's and R2's, equal at full scale."""
    import numpy as np
    import torch

    import lz4tpu_torch as lt
    from lz4tpu_torch import hostpack
    from lz4tpu_torch.frame import compress as frame_compress
    from lz4tpu_torch.frame.format import scan_frame
    from lz4tpu_torch.kernels import pack
    from lz4tpu_torch.parallel import blocks as block_work

    # (a) staging reuse
    rng = np.random.default_rng(11)

    def rows_of(seed):
        items = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                 for n in np.random.default_rng(seed).integers(0, 1 << 16, 96)]
        (rows, lens), = hostpack.upload("cuda", hostpack.Rows(items))
        return rows, lens.cpu().numpy(), b"".join(items)

    def address(fetched):
        return np.frombuffer(fetched.buffer, np.uint8).ctypes.data

    rows_a, lens_a, want_a = rows_of(1)
    rows_b, lens_b, want_b = rows_of(2)
    held = hostpack.fetch(rows_a, lens_a).wait()
    first = address(held)
    if b"".join(held) != want_a:
        fail("(11a) a fetch differs from its upload")
    for _ in range(4):
        other = hostpack.fetch(rows_b, lens_b).wait()
        if b"".join(other) != want_b or address(other) == first:
            fail("(11a) a fetch differs from its upload, or took a buffer still held")
        del other
    data = members[list(members)[0]][: 8 << 20]
    frame = lt.compress_frame_parallel(data, 65536, content_checksum=False)
    payloads = [p for c, p, _ in scan_frame(lt.LZ4FrameReader(frame))[0] if c]
    decoded = block_work.decode_payloads(payloads, 65536, b"", (torch.device("cuda"),))
    snapshot = b"".join(decoded)
    if b"".join(held) != want_a:
        fail("(11a) a held result changed while later calls took staging")
    del held
    again = hostpack.fetch(rows_b, lens_b).wait()
    reused = address(again) == first
    block_work.decode_payloads(payloads[::-1], 65536, b"", (torch.device("cuda"),))
    if b"".join(decoded) != snapshot or b"".join(again) != want_b:
        fail("(11a) decoded rows changed while a later decode took staging")
    print(f"  (11a) staging reuse: held results unchanged over later fetches and decodes; a "
          f"buffer let go {'was' if reused else 'was not'} taken by the next fetch")
    del again, decoded

    # (b) many units, several times each, at the budget and shrunk
    budget = pack.DECODE_BUDGET
    data = b"".join(d[: max(int(len(d) * min(scale, 0.1)), 1 << 20)]
                    for d in members.values())[: 24 << 20]
    frame = lt.compress_frame_parallel(data, 65536, content_checksum=True)
    segs = [data[i : i + SEGMENT] for i in range(0, len(data), SEGMENT)]
    linked = [lt.compress_frame_parallel(s, 65536, parallel_linked=True) for s in segs]
    want_writer = lt.compress_frame_parallel(data, 65536, block_checksums=True)
    calls = (
        ("decompress_frame_parallel", lambda: lt.decompress_frame_parallel(frame), data),
        ("read_all", lambda: lt.LZ4FrameReader(frame).read_all(), data),
        ("mesh of 3 x cuda:0", lambda: lt.decompress_frame_parallel(
            frame, mesh=lt.make_mesh(devices=["cuda:0"] * 3)), data),
        ("linked waves", lambda: b"".join(lt.decompress_frames_parallel(linked)), data),
        ("batched writer", lambda: lt.CompressionSettings().block_size(1 << 16)
         .block_checksums(True).compress_bytes(data), want_writer),
    )
    old_batch = frame_compress.BATCH_BYTES
    try:
        frame_compress.BATCH_BYTES = 2 << 20
        for shrunk in (False, True):
            if shrunk:
                pack.DECODE_BUDGET = 24 * (2 * 65536 + 64)  # groups of about 24 blocks
            for k in range(2):
                for label, fn, want in calls:
                    if fn() != want:
                        fail(f"(11b) {label} gave other bytes with units in flight (pass {k}, "
                             f"budget {pack.DECODE_BUDGET:,d} B)")
    finally:
        pack.DECODE_BUDGET = budget
        frame_compress.BATCH_BYTES = old_batch
    print(f"  (11b) {len(data):,d} B at depth {block_work.PIPELINE_DEPTH}: a frame of 64 KiB "
          f"blocks (on one device and on 3 entries of cuda:0), {len(segs)} linked frames in "
          "waves, the writer in 2 MiB batches; at the budget and at about 24 blocks a group: "
          "bytes equal in 2 passes each")

    # (c) the device trace of phase 3's mozilla decompress and 5a's compress
    name = max(members, key=lambda m: len(members[m]))
    path = os.path.join(HERE, "lz4tpu_torch", "_build", "transport_trace.json")
    traces = {
        "(11c) phase 3 decompress": trace_call(
            f"(11c) phase 3's {name} decompress", lambda: lt.decompress_frame_parallel(
                frames_3[name]), path),
        "(11c) 5a compress": trace_call(
            f"(11c) 5a's {name} compress (lane, 4 MiB blocks)", lambda: lt.compress_frame_parallel(
                members[name], 4 << 20, lane_kernel=True), path),
    }
    for label, t in traces.items():
        for kind, c in t["copies"].items():
            if "Pageable" in kind and c["largest"] > PAGEABLE_MAX:
                fail(f"{label}: a pageable copy of {c['largest']:,d} B ({kind})")
    print(f"  (11c) no pageable copy over {PAGEABLE_MAX:,d} B on either trace")

    # (d) launches beside the runs before the transport
    counts = {}
    for key, report in paths.items():
        if key != "10":
            for kernel, r in report.items():
                counts[kernel] = counts.get(kernel, 0) + r["launches"]
    for label, got, want in (("3-8", counts, LAUNCHES_3_8), ("9", launches_9, LAUNCHES_9)):
        line = ", ".join(f"{k} {got.get(k, 0)} ({want.get(k, 0)})" for k in
                         sorted(set(got) | set(want)) if got.get(k, 0) or want.get(k, 0))
        print(f"  (11d) phases {label}: launches (before the transport): {line}")
        if scale == 1.0 and {k: v for k, v in got.items() if v} != want:
            fail(f"(11d) phases {label} launch other counts than before the transport")
    return traces


def profile_lane(members):
    """The largest member through phase 5: (a) 4 MiB independent lane
    blocks, (c) its 1 MiB segments as linked lane frames."""
    import lz4tpu_torch as lt

    name = max(members, key=lambda m: len(members[m]))
    data = members[name]
    title = f"{name} ({len(data):,d} B)"
    frame = lt.compress_frame_parallel(data, 4 << 20, lane_kernel=True)
    profile_calls(title + ", (5a) lane, 4 MiB independent blocks", (
        ("compress", lambda: lt.compress_frame_parallel(data, 4 << 20, lane_kernel=True)),
        ("decompress", lambda: lt.decompress_frame_parallel(frame)),
    ))
    segments = [data[i : i + SEGMENT] for i in range(0, len(data), SEGMENT)]
    profile_calls(title + f", (5c) lane, {len(segments)} linked frames of 64 KiB blocks", (
        ("compress", lambda: [lt.compress_frame_parallel(seg, 65536, parallel_linked=True,
                                                         lane_kernel=True) for seg in segments]),
    ))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="Silesia stand-in scale for the main path (1.0 = 211,938,580 B)")
    ap.add_argument("--profile", action="store_true",
                    help="after each path, profile the largest member through it (host own "
                         "time by function, device busy share)")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "lz4tpu_torch")):
        print("chip_smoke: lz4tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    def phase(title):
        now = time.perf_counter()
        if marks:
            print(f"-- {marks[-1][0]}: {now - marks[-1][1]:.1f} s", flush=True)
        marks.append((title, now))
        if title:
            print(f"== {title}", flush=True)

    marks = []
    phase("phase 1: environment")
    smi = phase_env()

    from lz4tpu_torch.utils import silesia

    scale = args.scale
    t0 = time.perf_counter()
    members = silesia.corpus(scale, cache=False)
    print(f"corpus: {sum(map(len, members.values())):,d} B at scale {scale} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    phase("phase 2: kernels against their plain versions")
    lane = check_compress128(members)
    comp = check_compress(members)
    split = check_split(members)
    dec = check_decoders(members)
    check_push_windows()
    check_host_paths(members)
    checks = {"compress": comp, "compress_split": split, "compress128": lane, **dec}
    for name, r in checks.items():
        print(f"  {name}: {r['ms']:.3f} ms on the card, plain {r['plain_ms']:.1f} ms on the "
              f"host CPU, bound {r['bound_ms']:.4f} ms ({r['shape']})")
    phase("phase 3: 64 KiB independent blocks")
    report, scalar_3, frames_3 = phase_main(members, scale)
    paths = {"3": report}
    if args.profile:
        profile_round_trip(members)
    phase("phase 4: big blocks and linked frames")
    reports, scalar, frames_4a, frames_4b = phase_big_and_linked(members)
    paths.update(reports)
    if args.profile:
        profile_big_and_linked(members)
    phase("phase 5: the lane compressor, big blocks spliced from 32 KiB chunks")
    reports, frames_5a, summary_5a = phase_lane(members, {"3": scalar_3, **scalar})
    paths.update(reports)
    if args.profile:
        profile_lane(members)
    phase("phase 6: the reference's own entry points: streaming writer and reader, CLI")
    reports, mirror_6 = phase_streaming(members, frames_4a)
    paths.update(reports)
    phase("phase 7: the device mesh and the resumable sharded runner")
    paths.update(phase_mesh(members, {"3": frames_3, "4b": frames_4b, "5a": frames_5a},
                            {"3": scalar_3, "4b": scalar["4b"], "5a": summary_5a}))
    phase("phase 8: the host engine (native): level(), threads(n), linked frames, CLI")
    paths.update(phase_native(members, frames_4a, mirror_6, smi))
    phase("phase 9: F1, frames of one-byte blocks in bounded memory")
    launches_9 = phase_f1(smi)
    phase("phase 10: the bench, entry() and dryrun_multichip")
    paths.update(phase_bench_and_entry(scale))
    phase("phase 11: the transport: staging, units in flight, the device trace")
    phase_transport(members, frames_3, paths, launches_9, scale)
    phase("")

    rows = []
    for name, (_, mod) in kernel_stats().items():
        c = checks[name]
        on = {path: r[name] for path, r in paths.items() if r[name]["launches"]}
        rows.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": sum(r["launches"] for r in on.values()), "max_abs_err": c["err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape": c["shape"],
            "main_ms": sum(r["main_ms"] for r in on.values()),
            "main_bound_ms": sum(r["main_bound_ms"] for r in on.values()),
            "paths": on,
        })
        if "at_frame_rows" in c:
            rows[-1]["at_frame_rows"] = c["at_frame_rows"]
        if not rows[-1]["launches"]:
            fail(f"kernel {name} was launched on no path")
    print("kernels by time lost on the paths (launches, summed ms, summed bound ms, gap ms):")
    for r in sorted(rows, key=lambda r: r["main_bound_ms"] - r["main_ms"]):
        print(f"  {r['name']:12s} {r['launches']:4d} {r['main_ms']:10.1f} {r['main_bound_ms']:8.3f} "
              f"{r['main_ms'] - r['main_bound_ms']:10.1f}")
    print(smi)  # the card's name and power limit, again beside the results
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
