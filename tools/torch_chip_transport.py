#!/usr/bin/env python3
"""The port's frame paths and their transport on the card, for one checkout:

* phase 3 of ``chip_smoke.py``: every member of the Silesia stand-in through
  ``compress_frame_parallel(block_size=65536, content_checksum=True)`` and
  ``decompress_frame_parallel``, host wall MB/s;
* the bench's link section (``lz4tpu_torch.bench.bench_link``: the frame
  paths' own H2D and D2H of 256 MiB, ``link_h2d_mbps`` / ``link_d2h_mbps``,
  beside one pinned copy each way), its frame section over 32 MiB of the
  bench's mixed corpus (``frame_decode_mbps``, ``frame_compress_mbps``) and
  the ceilings the link rates set (``frame_decode_ceiling_mbps``);
* mozilla's decompress (phase 3) and 4 MiB lane compress (5a) under
  torch.profiler (``chip_smoke.trace_call``: each memcpy kind with its
  largest copy, the device's busy share of the call's wall), and the
  decompress's host own time by function (cProfile).

    python3 tools/torch_chip_transport.py [--root CHECKOUT] [--label L] [--scale S]

``--root`` imports ``lz4tpu_torch`` from another checkout (a parent unpacked
with ``git archive``), so that two trees are timed in one call on one card,
in turns.  Prints the card's name and power limit, the numbers, and last one
JSON line.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose lz4tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    ap.add_argument("--scale", type=float, default=1.0, help="Silesia stand-in scale")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke  # trace_call; imports nothing of the package at module level

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_chip_transport: needs a CUDA card", file=sys.stderr)
        return 2
    import lz4tpu_torch as lt
    from lz4tpu_torch import bench, build
    from lz4tpu_torch.utils import silesia

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"root {os.path.abspath(args.root)}: lz4tpu_torch from {os.path.dirname(lt.__file__)}")
    build.load()
    members = silesia.corpus(args.scale, cache=False)
    result = {"label": args.label, "card": smi}

    frames = {}
    n_in = t_comp = t_dec = 0.0
    for name, data in members.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = lt.compress_frame_parallel(data, 65536, content_checksum=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = lt.decompress_frame_parallel(frame)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back != data:
            raise SystemExit(f"phase 3: {name} does not round-trip")
        frames[name] = frame
        n_in += len(data)
        t_comp += t1 - t0
        t_dec += t2 - t1
    result["phase3_compress_mbps"] = round(n_in / t_comp / 1e6, 1)
    result["phase3_decompress_mbps"] = round(n_in / t_dec / 1e6, 1)
    print(f"phase 3: {int(n_in):,d} B, compress {result['phase3_compress_mbps']} MB/s, "
          f"decompress {result['phase3_decompress_mbps']} MB/s (host wall)")

    run = bench.Run("cuda")
    bench.bench_link(run)
    bench.bench_frame_parallel(run, bench.make_corpus(8.0))
    bench.frame_ceilings(run.extra)
    result.update({k: v for k, v in run.extra.items() if k.startswith(("link_", "frame_"))})

    name = max(members, key=lambda m: len(members[m]))
    path = os.path.join(os.path.abspath(args.root), "lz4tpu_torch", "_build", "trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for key, label, fn in (
        ("decompress", f"phase 3's {name} decompress",
         lambda: lt.decompress_frame_parallel(frames[name])),
        ("compress_5a", f"5a's {name} compress",
         lambda: lt.compress_frame_parallel(members[name], 4 << 20, lane_kernel=True)),
    ):
        t = chip_smoke.trace_call(label, fn, path)
        result[f"{key}_wall_ms"] = round(t["wall_ms"], 3)
        result[f"{key}_busy_share"] = round(t["busy_ms"] / t["wall_ms"], 4)
        result[f"{key}_copies"] = t["copies"]

    prof = cProfile.Profile()
    prof.enable()
    lt.decompress_frame_parallel(frames[name])
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(10)
    print(f"cProfile of phase 3's {name} decompress, by own time:")
    body = text.getvalue().splitlines()
    start = next(i for i, line in enumerate(body) if "ncalls" in line)
    for line in body[start:]:
        if line.strip():
            print("  " + line.rstrip()[:150])
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
