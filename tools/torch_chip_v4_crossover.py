#!/usr/bin/env python3
"""decode_v4.cu against decode_big.cu on blocks over 64 KiB, on the card,
by the rows of a group: whether and where their times cross.

    python3 tools/torch_chip_v4_crossover.py [--rows 1,4,16,64,128] [--reps 5]
                                             [--scale 1.0] [--frames]

For 1 MiB and 4 MiB blocks of the Silesia stand-in (``utils/silesia.py``;
each member cut into full blocks, those the greedy parse does not shrink
left out, the rest repeated in order up to the row count), each decoder
decodes ``rows`` blocks with the frame path's geometry: the comp width the
longest payload rounded to 16, the output capacity ``block_maxsize`` plus
that width, one call a ``DECODE_BUDGET`` group (``parallel.blocks.decode_payloads``).
The first call of each is checked block for block against the input; then
``reps`` passes of each, in turns (v4, big, big, v4, ...), are timed by
CUDA events around the launches alone (``KernelStats``).  A line a shape:
the median and best ms of each decoder, the bound (the blocks' bytes in
and out once at 3.35 TB/s) and each median's share of it.

``--frames`` adds the frame path itself: each member written as the lz4
CLI's default frame (4 MiB independent blocks, content checksum) by the
port's host engine, then read by ``decompress_frame_parallel`` with
``lane_kernel=True`` (``decode_big``) and ``lane_kernel=False``
(``decode_v4``) in turns, host wall, median of ``reps`` passes over the
12 members.

The last line is a JSON object of every number; the card's name and power
limit come first.  Needs one CUDA card and nvcc.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch

import lz4tpu_torch as lt
from lz4tpu_torch import build, hostpack
from lz4tpu_torch.bench import HBM_BYTES_PER_S, card_line, greedy, split
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels import decompress_v4 as dv4
from lz4tpu_torch.kernels.pack import budget_groups
from lz4tpu_torch.kernels.status import OK
from lz4tpu_torch.runtime import round_up
from lz4tpu_torch.utils import silesia

DECODERS = {"v4": (dv4.decode_v4, dv4.KERNEL), "big": (dbig.decode_big, dbig.KERNEL)}


def stand_in_blocks(members, block_size: int):
    """(blocks, payloads): the members' full blocks of ``block_size`` that
    the greedy parse shrinks, in corpus order."""
    blocks = [b for data in members.values() for b in split(data, block_size)
              if len(b) == block_size]
    comp = greedy(blocks)
    keep = [i for i, c in enumerate(comp) if len(c) < len(blocks[i])]
    return [blocks[i] for i in keep], [comp[i] for i in keep]


def shape(dev, blocks, comp, block_size: int, rows: int, reps: int) -> dict:
    """Both decoders over ``rows`` of the blocks, as ``decode_payloads``
    launches them."""
    pick = [i % len(blocks) for i in range(rows)]
    blocks, comp = [blocks[i] for i in pick], [comp[i] for i in pick]
    width = round_up(max(map(len, comp)), 16)
    out_capacity = round_up(block_size + width, 16)
    groups = budget_groups(rows, out_capacity + width)
    batches = [hostpack.upload_batch(dev, comp[a:b]) for a, b in groups]
    torch.cuda.synchronize(dev)

    def one_pass(name, check=False):
        decoder, stats = DECODERS[name]
        stats.reset(timing=True)
        for (a, b), batch in zip(groups, batches):
            out, out_len, status = decoder(*batch, block_size, out_capacity)
            if check:
                lens, st = out_len.tolist(), status.tolist()
                for j in range(b - a):
                    if st[j] != OK or bytes(out[j, : lens[j]].cpu().numpy()) != blocks[a + j]:
                        raise AssertionError(f"{name}: block {a + j} of {rows} x "
                                             f"{block_size >> 20} MiB: status {st[j]}")
            del out, out_len, status
        ms = stats.elapsed_ms()
        stats.reset()
        return ms

    for name in DECODERS:
        one_pass(name, check=True)
    times = {name: [] for name in DECODERS}
    for r in range(reps):
        for name in (("v4", "big") if r % 2 == 0 else ("big", "v4")):
            times[name].append(one_pass(name))
    moved = sum(map(len, blocks)) + sum(map(len, comp))
    bound = moved / HBM_BYTES_PER_S * 1e3
    a, b = groups[0]
    out = {"block_mib": block_size >> 20, "rows": rows, "groups": len(groups),
           "v4_scratch_rows": build.load().lz4t_decode_v4_group(b - a, width, out_capacity),
           "bound_ms": round(bound, 5)}
    for name, ts in times.items():
        med = statistics.median(ts)
        out[f"{name}_ms"] = round(med, 4)
        out[f"{name}_best_ms"] = round(min(ts), 4)
        out[f"{name}_bound_pct"] = round(bound / med * 100, 4)
    out["big_over_v4"] = round(out["big_ms"] / out["v4_ms"], 3)
    print(f"  {rows:4d} x {block_size >> 20} MiB ({len(groups)} group(s), v4 "
          f"{out['v4_scratch_rows']} rows a scratch group): v4 {out['v4_ms']:.3f} ms "
          f"(best {out['v4_best_ms']:.3f}, {out['v4_bound_pct']:.3f} % of bound), big "
          f"{out['big_ms']:.3f} ms (best {out['big_best_ms']:.3f}, "
          f"{out['big_bound_pct']:.3f} %), bound {bound:.4f} ms, big / v4 "
          f"{out['big_over_v4']:.2f}", flush=True)
    return out


def frames(dev, members, reps: int) -> dict:
    """Every member's lz4 CLI default frame read through the frame path on
    each route, in turns: host wall of a pass over the members."""
    settings = lt.CompressionSettings().engine("native").block_size(4 << 20) \
        .content_checksum(True)
    stored = [settings.compress_bytes(d, with_size=False) for d in members.values()]
    want = list(members.values())
    routes = {"big": True, "v4": False}
    for name, lane in routes.items():
        got = [lt.decompress_frame_parallel(f, device=dev, lane_kernel=lane) for f in stored]
        if got != want:
            raise AssertionError(f"frames on {name}: other bytes")
    times = {name: [] for name in routes}
    for r in range(reps):
        for name in (("v4", "big") if r % 2 == 0 else ("big", "v4")):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for f in stored:
                lt.decompress_frame_parallel(f, device=dev, lane_kernel=routes[name])
            times[name].append(time.perf_counter() - t0)
    total = sum(map(len, want))
    out = {}
    for name, ts in times.items():
        out[f"frames_{name}_mbps"] = round(total / statistics.median(ts) / 1e6, 2)
        out[f"frames_{name}_s"] = [round(t, 4) for t in ts]
    print(f"  frames, 12 members, {total:,d} B: v4 {out['frames_v4_mbps']} MB/s, big "
          f"{out['frames_big_mbps']} MB/s (medians of {reps} passes)", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="1,4,16,64,128")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--frames", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(f"device: {card_line()}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    build.load()
    members = silesia.corpus(args.scale, cache=False)
    result = {"device": card_line(), "shapes": []}
    for block_size in (1 << 20, 4 << 20):
        blocks, comp = stand_in_blocks(members, block_size)
        print(f"{block_size >> 20} MiB: {len(blocks)} blocks the parse shrinks "
              f"({sum(map(len, comp)) / sum(map(len, blocks)):.4f} of their bytes)", flush=True)
        for rows in map(int, args.rows.split(",")):
            result["shapes"].append(shape(dev, blocks, comp, block_size, rows, args.reps))
            torch.cuda.empty_cache()
    if args.frames:
        result.update(frames(dev, members, args.reps))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
