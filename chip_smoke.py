#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py                 # full run: needs one CUDA card
    python3 chip_smoke.py --scale 0.05    # smaller corpus (main path)
    python3 chip_smoke.py --profile       # + host profile of one round trip

Phases, in order; any mismatch or exception exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, and the kernel build (nvcc, one process per source);
2. every CUDA kernel against its plain PyTorch version on the same inputs
   (the plain version runs on a CPU copy): the greedy compressor (U16/U32
   tables, acceleration 1 and 8, dictionary-primed tables with a cursor,
   in-kernel priming, caps that trigger Incompressible), decode128 and
   decompress_v4 (64 KiB prefixes, hostile blocks, 1 MiB and 4 MiB blocks
   for v4).  Bytes, lengths, statuses and tables must be equal: a byte
   codec has no tolerance;
3. the main path at full size: each Silesia stand-in member (scale 1.0:
   211,938,580 bytes) through ``compress_frame_parallel(block_size=65536,
   content_checksum=True)`` and ``decompress_frame_parallel`` on the card,
   plus a dictionary frame and a 4 MiB-block frame; outputs must be
   byte-equal to the inputs and every kernel's launch count above zero.

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


def cut_blocks(data: bytes, size: int, k: int):
    """``k`` blocks of ``size`` bytes spread evenly over ``data``."""
    span = max(len(data) - size, 0)
    return [data[(span * j) // max(k - 1, 1):][:size] for j in range(k)]


def same(name, got, want) -> int:
    """Hold kernel tensors against plain ones exactly; returns the largest
    absolute difference (0)."""
    import torch

    for label, g, w in zip(("out", "out_len", "status", "tables"), got, want):
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
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line or line.startswith("=="):
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

    def batch(datas, cursors, caps, accel, tables, prime):
        n = len(datas)
        width = max(len(d) for d in datas)
        arr = np.zeros((n, width), np.uint8)
        for i, d in enumerate(datas):
            arr[i, : len(d)] = np.frombuffer(d, np.uint8)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32)

        return (
            torch.from_numpy(arr), i32([len(d) for d in datas]), i32(cursors), i32(caps),
            i32([accel] * n), i32([0] * n), i32(prime), torch.from_numpy(tables),
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

    err = 0
    timing = {}
    for name, args in cases.items():
        width = args[0].shape[1]
        cap = -(-compress_bound(width) // 16) * 16
        t0 = time.perf_counter()
        want = kc.compress_plain(*args, cap)
        plain_ms = (time.perf_counter() - t0) * 1e3
        dev_args = [a.cuda() for a in args]
        got = kc.compress_batch(*dev_args, cap)
        torch.cuda.synchronize()
        err = max(err, same(f"compress[{name}]", got, want))
        n_inc = int((want[2] == 1).sum())
        print(f"  compress[{name}]: {len(args[1])} blocks, {n_inc} incompressible, "
              f"equal to plain")
        if name == "u32_main":
            if not n_inc:
                fail("compress: no block of the capped batch was incompressible")
            ms = cuda_ms(lambda: kc.compress_batch(*dev_args, cap))
            moved = int(args[1].sum()) + int(want[1].sum()) + 2 * 4 * U32_SLOTS * len(args[1])
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                          shape=f"{n} x 64 KiB blocks, U32 tables, cap = block size")
    return dict(err=err, **timing)


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


def check_decoders(members):
    """decode128 and decompress_v4 against their plain version."""
    import numpy as np
    import torch

    from lz4tpu_torch.kernels import decode128 as d128
    from lz4tpu_torch.kernels import decompress_v4 as dv4
    from lz4tpu_torch.kernels.compress import compress_blocks
    from lz4tpu_torch.kernels.pack import pack_rows
    from lz4tpu_torch.spec.table import U32Table

    rng = random.Random(0x5EED)
    names = list(members)
    per = 16
    raw = [b for m in names for b in cut_blocks(members[m], 65536, per)]
    comp, _ = compress_blocks(raw, device="cuda")
    comp = [c if c is not None else b"" for c in comp]
    # blocks that reach into a 64 KiB prefix: [prefix | block] from cursor 64 KiB
    pre_raw = [b for m in names[:4] for b in cut_blocks(members[m], 2 * 65536, 8)]
    pcomp, _ = compress_blocks(pre_raw, cursors=[65536] * len(pre_raw),
                               tables=[U32Table() for _ in pre_raw], prime_prefix=True,
                               device="cuda")
    blocks = comp + [c for c in pcomp if c is not None]
    prefixes = [b""] * len(comp) + [r[:65536] for r, c in zip(pre_raw, pcomp) if c is not None]
    hostile = hostile_blocks(comp[:: max(len(comp) // 16, 1)], rng)
    blocks += hostile
    prefixes += [rng.choice([b"", raw[0][:300]]) for _ in hostile]

    def tensors(blks, pfx):
        c, cl = pack_rows(blks, "cpu")
        p, pl = pack_rows(pfx, "cpu", align_right=True)
        return c, cl, p, pl

    args = tensors(blocks, prefixes)
    report = {}
    for name, fn in (("decode128", d128.decode128), ("decode_v4", dv4.decode_v4)):
        want = d128.decode_plain(*args, 65536, -(-(65536 + args[0].shape[1]) // 16) * 16)
        got = fn(*(a.cuda() for a in args), 65536)
        torch.cuda.synchronize()
        err = same(name, got, want)
        st = want[2].numpy()
        kinds = {int(s): int((st == s).sum()) for s in np.unique(st)}
        print(f"  {name}: {len(blocks)} blocks (statuses {kinds}), equal to plain")
        if len(kinds) < 5:
            fail(f"{name}: the hostile batch did not reach every status: {kinds}")
        report[name] = dict(err=err)

    # timing at decode128's main-path shape: the valid 64 KiB blocks, no
    # prefix (decode_v4 on the same batch is printed for comparison)
    targs = tensors(comp, [b""] * len(comp))
    moved = int(targs[1].sum()) + sum(len(r) for r in raw)
    for name, fn in (("decode128", d128.decode128), ("decode_v4", dv4.decode_v4)):
        t0 = time.perf_counter()
        d128.decode_plain(*targs, 65536, -(-(65536 + targs[0].shape[1]) // 16) * 16)
        plain_ms = (time.perf_counter() - t0) * 1e3
        dev = [a.cuda() for a in targs]
        ms = cuda_ms(lambda: fn(*dev, 65536))
        timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                      shape=f"{len(comp)} x 64 KiB blocks")
        if name == "decode128":
            report[name].update(timing)
        else:
            print(f"  decode_v4 at decode128's shape: {ms:.3f} ms on the card "
                  f"(decode128 {report['decode128']['ms']:.3f} ms)")

    # v4 beyond the TPU version's windows: 1 MiB and 4 MiB blocks
    sizes = [1 << 20, 4 << 20]
    big_raw = [cut_blocks(members[m], s, 1)[0] for s in sizes for m in names[:3]]
    big_comp, _ = compress_blocks(big_raw, device="cuda")
    big = [c if c is not None else r for c, r in zip(big_comp, big_raw)]
    bargs = tensors(big, [b""] * len(big))
    limit = max(sizes)
    t0 = time.perf_counter()
    want = d128.decode_plain(*bargs, limit, -(-(limit + bargs[0].shape[1]) // 16) * 16)
    plain_ms = (time.perf_counter() - t0) * 1e3
    dev = [a.cuda() for a in bargs]
    got = dv4.decode_v4(*dev, limit)
    torch.cuda.synchronize()
    report["decode_v4"]["err"] = max(report["decode_v4"]["err"], same("decode_v4[big]", got, want))
    for i, r in enumerate(big_raw):
        if big_comp[i] is not None and want[0][i, : len(r)].numpy().tobytes() != r:
            fail(f"decode_v4[big]: block {i} does not round-trip")
    mib = [s >> 20 for s in sizes]
    print(f"  decode_v4[big]: {len(big)} blocks of {mib} MiB, equal to plain")
    # timing at decode_v4's main-path shape: blocks over 64 KiB
    moved = int(bargs[1].sum()) + int(want[1].sum())
    report["decode_v4"].update(
        ms=cuda_ms(lambda: dv4.decode_v4(*dev, limit)), plain_ms=plain_ms,
        bound_ms=moved / HBM_BYTES_PER_S * 1e3,
        shape=" + ".join(f"{len(names[:3])} x {m} MiB" for m in mib) + " blocks")
    return report


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


def profile_round_trip(members):
    """Host-side breakdown (cProfile) of the largest member's round trip,
    kernels on the card: where the wall time outside the kernels goes."""
    import cProfile
    import io
    import pstats

    import lz4tpu_torch as lt

    name = max(members, key=lambda m: len(members[m]))
    data = members[name]
    frame = lt.compress_frame_parallel(data, 65536, content_checksum=True)
    for label, fn in (
        ("compress", lambda: lt.compress_frame_parallel(data, 65536, content_checksum=True)),
        ("decompress", lambda: lt.decompress_frame_parallel(frame)),
    ):
        prof = cProfile.Profile()
        prof.enable()
        fn()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
        print(f"== profile: {label} of {name} ({len(data):,d} B), by own time")
        body = text.getvalue().splitlines()
        start = next(i for i, line in enumerate(body) if "ncalls" in line)
        for line in body[start:]:
            if line.strip():
                print("  " + line.rstrip()[:150])
        device_share(label, fn)


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


def frame_stats(frame: bytes):
    """(compressed payload bytes, stored payload bytes, compressed-block
    count, stored-block count) of a frame made by this package's writer."""
    pos = 6
    flg = frame[4]
    pos += 8 if flg & 0x08 else 0
    pos += 4 if flg & 0x01 else 0
    pos += 1
    comp_bytes = stored_bytes = nc = ns = 0
    while True:
        ln = int.from_bytes(frame[pos : pos + 4], "little")
        pos += 4
        if ln == 0:
            return comp_bytes, stored_bytes, nc, ns
        if ln & (1 << 31):
            ns += 1
            stored_bytes += ln & 0x7FFFFFFF
        else:
            nc += 1
            comp_bytes += ln
        pos += (ln & 0x7FFFFFFF) + (4 if flg & 0x10 else 0)


def phase_main(members, scale: float):
    import torch

    import lz4tpu_torch as lt
    from lz4tpu_torch.kernels import compress as kc
    from lz4tpu_torch.kernels import decode128 as d128
    from lz4tpu_torch.kernels import decompress_v4 as dv4

    kernels = (kc.KERNEL, d128.KERNEL, dv4.KERNEL)
    traffic = {k.name: 0 for k in kernels}  # bytes each kernel must move
    for k in kernels:
        k.reset(timing=True)
    total_in = total_out = 0
    t_comp = t_dec = 0.0
    print(f"main path: scale {scale}, 64 KiB blocks, content checksum")
    for name, data in members.items():
        torch.cuda.synchronize()
        ms0 = {k.name: k.elapsed_ms() for k in kernels}
        t0 = time.perf_counter()
        frame = lt.compress_frame_parallel(data, block_size=65536, content_checksum=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = lt.decompress_frame_parallel(frame)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != data:
            fail(f"main path: {name} does not round-trip")
        comp_bytes, stored, nc, ns = frame_stats(frame)
        traffic["compress"] += len(data) + comp_bytes + 2 * 4 * 4096 * (nc + ns)
        traffic["decode128"] += comp_bytes + len(data) - stored
        total_in += len(data)
        total_out += len(frame)
        t_comp += t1 - t0
        t_dec += t2 - t1
        ms = {k.name: k.elapsed_ms() - ms0[k.name] for k in kernels}
        print(f"  {name:8s} {len(data):>11,d} B ratio {len(frame) / len(data):.4f} "
              f"compress {len(data) / (t1 - t0) / 1e6:8.1f} MB/s "
              f"decompress {len(data) / (t2 - t1) / 1e6:8.1f} MB/s "
              f"kernel ms: compress {ms['compress']:.2f} decode128 {ms['decode128']:.2f} "
              f"({nc} blocks decoded, {ns} stored)")
    # a dictionary frame (shared 64 KiB prefix) and a 4 MiB-block frame (v4)
    names = list(members)
    dic = members[names[0]][-65536:]
    data = members[names[7]]
    frame = lt.compress_frame_parallel(data, 65536, dictionary=dic, block_checksums=True)
    if lt.decompress_frame_parallel(frame, dictionary=dic) != data:
        fail("main path: dictionary frame does not round-trip")
    comp_bytes, stored, nc, ns = frame_stats(frame)
    traffic["compress"] += len(data) + (nc + ns) * len(dic) + comp_bytes + 2 * 4 * 4096 * (nc + ns)
    traffic["decode128"] += comp_bytes + len(data) - stored + len(dic)
    print(f"  dictionary frame: {names[7]} with a 64 KiB dictionary, ratio "
          f"{len(frame) / len(data):.4f}, round trip equal")
    data = members[names[-1]]
    frame = lt.compress_frame_parallel(data, 4 << 20)
    if lt.decompress_frame_parallel(frame) != data:
        fail("main path: 4 MiB-block frame does not round-trip")
    comp_bytes, stored, nc, ns = frame_stats(frame)
    traffic["compress"] += len(data) + comp_bytes + 2 * 4 * 4096 * (nc + ns)
    traffic["decode_v4"] += comp_bytes + len(data) - stored
    print(f"  4 MiB-block frame: {names[-1]}, ratio {len(frame) / len(data):.4f}, "
          f"round trip equal")
    torch.cuda.synchronize()
    report = {}
    for k in kernels:
        report[k.name] = dict(launches=k.launches, main_ms=k.elapsed_ms(),
                              main_bound_ms=traffic[k.name] / HBM_BYTES_PER_S * 1e3)
        k.reset()
        if report[k.name]["launches"] <= 0:
            fail(f"main path: kernel {k.name} was never launched")
    print(f"main path total: {total_in:,d} B in, ratio {total_out / total_in:.4f}, "
          f"compress {total_in / t_comp / 1e6:.1f} MB/s, "
          f"decompress {total_in / t_dec / 1e6:.1f} MB/s (host wall, incl. transfers)")
    print("launches: " + ", ".join(f"{n}={r['launches']}" for n, r in report.items()))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="Silesia stand-in scale for the main path (1.0 = 211,938,580 B)")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, profile one member's round trip on the host")
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

    print("== phase 1: environment", flush=True)
    phase_env()

    from lz4tpu_torch.kernels import compress as kc
    from lz4tpu_torch.kernels import decode128 as d128
    from lz4tpu_torch.kernels import decompress_v4 as dv4
    from lz4tpu_torch.utils import silesia

    scale = args.scale
    t0 = time.perf_counter()
    members = silesia.corpus(scale, cache=False)
    print(f"corpus: {sum(map(len, members.values())):,d} B at scale {scale} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    print("== phase 2: kernels against their plain versions", flush=True)
    comp = check_compress(members)
    dec = check_decoders(members)
    check_host_paths(members)
    checks = {"compress": comp, **dec}
    for name, r in checks.items():
        print(f"  {name}: {r['ms']:.3f} ms on the card, plain {r['plain_ms']:.1f} ms on the "
              f"host CPU, bound {r['bound_ms']:.4f} ms ({r['shape']})")
    print("== phase 3: main path", flush=True)
    main_report = phase_main(members, scale)
    if args.profile:
        profile_round_trip(members)

    rows = []
    for mod in (kc, d128, dv4):
        name = mod.KERNEL.name
        c, m = checks[name], main_report[name]
        rows.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": m["launches"], "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": c["shape"], "main_ms": m["main_ms"],
            "main_bound_ms": m["main_bound_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
