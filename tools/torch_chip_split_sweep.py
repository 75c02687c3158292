#!/usr/bin/env python3
"""compress.cu's split parse against its one-warp kernel on the card: the
bytes, the kernel time by seam spacing, and where the hand-offs fell.

    python3 tools/torch_chip_split_sweep.py [--seams 131072,262144] [--reps 3]
                                            [--scale 1.0] [--seed N] [--members a,b]
                                            [--blocks 262144,1048576,4194304]

Each member of the benchmark's Silesia stand-in (``lz4bench/corpora/
silesia.py`` at ``--seed``) is laid out as ``parallel.blocks.scalar_launch``
lays out its frame of each block size of ``--blocks`` (default 4 MiB): one
row a block, cap = block size, output rows of block size + 16.  A member's
rows go through ``compress_batch`` (the one-warp kernel) and through
``compress_split`` at every seam spacing of ``--seams`` and at the spacing
``split_seam`` gives the member's launch on this card (marked ``rule``;
none where the rule keeps the launch on the one-warp kernel).  Every split
launch's statuses, the lengths of its compressed rows and its output rows
are held against the one-warp launch's; then ``--reps`` passes of each are
timed in turns by CUDA events around ``compress_split`` (both kernels, the
allocations).  Two more shapes a block size: one row of ``xml`` alone, and
one random row (no search start in common, so every seam is taken over:
the split path's worst case).

A line a shape and spacing: ms of each, the speed-up, the seams, the
seams taken over, and the bytes the warps parsed (the median and the
largest run past its own seam, from the records).  The card's name and
power limit come first; the last line is a JSON object of every number.
Needs one CUDA card and nvcc.
"""

import argparse
import json
import pathlib
import random
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from lz4bench.corpora import silesia
from lz4tpu_torch import build
from lz4tpu_torch.bench import card_line
from lz4tpu_torch.kernels import compress as kc
from lz4tpu_torch.parallel.blocks import block_lens
from lz4tpu_torch.runtime import round_up, stream_handle
from lz4tpu_torch.spec.table import U32_SLOTS

def rows_of(data: bytes, block: int):
    """(rows, n, cap, accel) on the card, as the frame writer lays them out."""
    lens = block_lens(len(data), block)
    arr = np.zeros((len(lens), block), np.uint8)
    arr.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    return (torch.from_numpy(arr).cuda(), i32(lens), i32(lens), i32([1] * len(lens))), lens


def one_warp(rows, n, cap, accel):
    zeros = torch.zeros_like(n)
    tables = torch.zeros((rows.shape[0], U32_SLOTS), dtype=torch.int32, device="cuda")
    return kc.compress_batch(rows, n, zeros, cap, accel, zeros, zeros, tables,
                             round_up(rows.shape[1] + 16, 16))[:3]


def split(rows, n, cap, accel, lens, seam):
    """``compress_split``'s launch with its buffers kept: (out, out_len,
    status, counts, bytes each warp parsed past its seam)."""
    plan = kc.split_plan(lens, seam)
    warps = torch.from_numpy(plan.warps).cuda()
    first = torch.from_numpy(plan.row_first).cuda()
    width = round_up(rows.shape[1] + 16, 16)
    n_rows, n_warps = rows.shape[0], plan.warps.shape[0]
    zeros = torch.zeros(n_rows * width + 4 * n_warps, dtype=torch.uint8, device="cuda")
    out = zeros[: n_rows * width].view(n_rows, width)
    rec_bytes = kc.RECORD_BYTES * plan.records
    scratch = torch.empty(rec_bytes + kc.RECORD_BYTES * kc.DEFERRED_RUNS * n_warps
                          + plan.scratch_bytes, dtype=torch.uint8, device="cuda")
    handoff = torch.empty((n_warps, 8), dtype=torch.int32, device="cuda")
    meta = torch.empty((4, n_rows), dtype=torch.int32, device="cuda")
    rc = build.load().lz4t_compress_split(
        rows.data_ptr(), rows.stride(0), n.data_ptr(), cap.data_ptr(), accel.data_ptr(),
        warps.data_ptr(), first.data_ptr(), n_warps, n_rows, seam, scratch.data_ptr(),
        rec_bytes, zeros[n_rows * width :].data_ptr(), handoff.data_ptr(), out.data_ptr(),
        width, meta.data_ptr(), stream_handle())
    build.check(rc, "compress_split")
    recs = scratch[:rec_bytes].view(torch.int32).view(-1, 4).cpu().numpy()
    ho = handoff.cpu().numpy()
    parsed = [int(recs[w[4] + ho[i, 5] - 1, 2]) - int(w[1]) * seam
              for i, w in enumerate(plan.warps)]
    return out, meta[0], meta[1], meta[2:], parsed


def timed(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def profile(name, calls):
    """Device time by kernel of three calls of each path (torch.profiler)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    for key, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 3 / 1e3, e.count // 3) for e in p.key_averages()
                if e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        print(f"  profile {name}, {key}: " + "; ".join(
            f"{k[:40]} {ms:.3f} ms x{c}" for k, ms, c in rows[:6]), flush=True)


def same(label, want, got):
    w_out, w_len, w_st = (t.cpu() for t in want)
    g_out, g_len, g_st = (t.cpu() for t in got)
    if not torch.equal(w_st, g_st):
        raise SystemExit(f"{label}: statuses differ: {w_st.tolist()} / {g_st.tolist()}")
    ok = w_st == 0
    if not torch.equal(w_len[ok], g_len[ok]):
        raise SystemExit(f"{label}: lengths differ: {w_len.tolist()} / {g_len.tolist()}")
    if not torch.equal(w_out[ok], g_out[ok]) or g_out[~ok].any():
        raise SystemExit(f"{label}: output rows differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seams", default="131072,196608,262144,393216,524288")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--members", default="")
    ap.add_argument("--blocks", default=str(4 << 20))
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel (torch.profiler) of each call at every shape")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    members = silesia.members(args.seed, args.scale)
    if args.members:
        members = {k: v for k, v in members.items() if k in args.members.split(",")}
    shapes = {}
    for block in (int(b) for b in args.blocks.split(",") if b):
        tag = "" if block == 4 << 20 else f" @ {block >> 10} KiB blocks"
        shapes.update({name + tag: (data, block) for name, data in members.items()})
        if "xml" in members:
            shapes["xml, one row" + tag] = (members["xml"][:block], block)
        shapes["random row" + tag] = (random.Random(args.seed).randbytes(block), block)
    spacings = [int(s) for s in args.seams.split(",") if s]
    report = {"card": card_line(), "sms": sms, "seed": args.seed, "shapes": {}}
    for name, (data, block) in shapes.items():
        args_dev, lens = rows_of(data, block)
        rule = kc.split_seam(lens, sms)
        seams = sorted(set(spacings) | ({rule} if rule else set()))
        seams = [s for s in seams if int(lens.max()) >= 2 * s]
        want = one_warp(*args_dev)
        calls = {"one_warp": lambda: one_warp(*args_dev)}
        info = {}
        for seam in seams:
            out, out_len, status, counts, parsed = split(*args_dev, lens, seam)
            same(f"{name} at seam {seam}", want, (out, out_len, status))
            counts = counts.cpu()
            info[seam] = dict(seams=int(counts[0].sum()), taken_over=int(counts[1].sum()),
                              warps=len(parsed), parsed_median=int(statistics.median(parsed)),
                              parsed_max=int(max(parsed)))
            plan = kc.split_plan(lens, seam)
            plan = plan._replace(warps=torch.from_numpy(plan.warps).cuda(),
                                 row_first=torch.from_numpy(plan.row_first).cuda())
            rows, n, cap, accel = args_dev
            calls[seam] = (lambda s=seam, p=plan: kc.compress_split(
                rows, n, cap, accel, s, p, round_up(block + 16, 16)))
        times = {k: [] for k in calls}
        for r in range(args.reps):
            for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                times[k].append(timed(calls[k]))
        if args.profile:
            profile(name, calls)
        base = statistics.median(times["one_warp"])
        shape = {"bytes": len(data), "block": block, "rows": len(lens), "rule": rule,
                 "one_warp_ms": base, "split": {}}
        print(f"{name}: {len(data):,d} B in {len(lens)} rows; one warp a row "
              f"{base:.3f} ms; rule seam {rule}", flush=True)
        for seam in seams:
            ms = statistics.median(times[seam])
            shape["split"][seam] = dict(ms=ms, **info[seam])
            print(f"  seam {seam:>8d}{' (rule)' if seam == rule else '':7s} {ms:9.3f} ms "
                  f"x{base / ms:6.2f}  warps {info[seam]['warps']:4d}  seams "
                  f"{info[seam]['seams']:4d}  taken over {info[seam]['taken_over']:4d}  "
                  f"parsed median {info[seam]['parsed_median']:,d} max "
                  f"{info[seam]['parsed_max']:,d}", flush=True)
        report["shapes"][name] = shape
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
